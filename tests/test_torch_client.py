"""The port's client side: ``ClientTester``'s suite, ``ClientBench``,
the repl, the ``cli.client`` entry point and ``utils/config``, against a
live port cluster (MultiPaxos, 2 groups, on the CPU) and, for the pure
parts, against the JAX package's functions on the same inputs.
"""

import dataclasses
import io
import json

import pytest
import torch

from summerset_tpu.client import bench as jbench
from summerset_tpu.client import repl as jrepl
from summerset_tpu.client import tester as jtester
from summerset_tpu.utils import config as jconfig
from summerset_tpu_torch.client import bench as tbench
from summerset_tpu_torch.client import repl as trepl
from summerset_tpu_torch.client import tester as ttester
from summerset_tpu_torch.client.endpoint import GenericEndpoint
from summerset_tpu_torch.cluster import Cluster
from summerset_tpu_torch.utils import config as tconfig
from summerset_tpu_torch.utils.errors import SummersetError

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster("MultiPaxos", 3, tmp_path_factory.mktemp("torch_client"),
                num_groups=2,
                config={"hear_timeout_lo": 10, "hear_timeout_hi": 20},
                device="cpu")
    c.manager.settle_delay = 0.2
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


def _check(cluster, results):
    if not all(v == "PASS" for v in results.values()):
        dumps = {me: rep.debug_state()
                 for me, rep in sorted(cluster.replicas.items())}
        raise AssertionError(f"{results}\nreplica states: {dumps}")


def test_tester_names_match_jax():
    assert ttester.ALL_TESTS == jtester.ALL_TESTS


@pytest.mark.parametrize("names", [
    ["primitive_ops", "client_reconnect", "node_pause_resume"],
    ["non_leader_pause", "leader_node_pause", "non_leader_reset"],
    ["leader_node_reset", "two_nodes_reset", "all_nodes_reset"],
], ids=["basic", "faults", "resets"])
def test_tester_suite(cluster, names):
    """``ALL_TESTS`` in the three groups of
    ``tests/test_cluster.py::TestClusterTesterSuite``."""
    results = ttester.ClientTester(cluster.manager_addr,
                                   settle=1.5).run_tests(names)
    assert sorted(results) == sorted(names)
    _check(cluster, results)


def test_bench_three_seconds(cluster):
    ep = GenericEndpoint(cluster.manager_addr)
    ep.connect()
    try:
        summary = tbench.ClientBench(ep, secs=3.0, freq=200.0,
                                     put_ratio=0.5, value_size="64",
                                     num_keys=5, seed=3).run()
    finally:
        ep.leave()
    assert sorted(summary) == ["acked", "issued", "lat_p50_ms",
                               "lat_p99_ms", "tput"]
    assert summary["acked"] > 10, summary
    assert summary["issued"] >= summary["acked"]
    assert 0 < summary["lat_p50_ms"] <= summary["lat_p99_ms"]


def test_repl_commands(cluster):
    """The repl's commands and replies.  The first put may land at a
    follower (the suite above moved leadership) and print ``redirect``;
    the endpoint follows the hint, so the put is repeated until it
    succeeds.  The never-written key routes to the same group as ``rk``
    (the two groups may have different leaders)."""
    import zlib

    assert trepl.ClientRepl.HELP == jrepl.ClientRepl.HELP
    out = io.StringIO()
    G = cluster.num_groups
    none_key = next(k for k in (f"rk_none{i}" for i in range(64))
                    if zlib.crc32(k.encode()) % G
                    == zlib.crc32(b"rk") % G)

    def script():
        for _ in range(10):
            yield "put rk hello world\n"
            if out.getvalue().splitlines()[-1] == "success: rk set":
                break
        for line in ("get rk", "", "help", "bogus", "get",
                     f"get {none_key}", "exit", "get rk"):
            yield line + "\n"

    trepl.ClientRepl(cluster.manager_addr).run(stdin=script(), stdout=out)
    got = out.getvalue().splitlines()
    help_ = trepl.ClientRepl.HELP
    n = got.index("success: rk set")
    assert got[0] == help_
    assert set(got[1:n]) <= {"redirect: rk set"}, got
    assert got[n:] == ["success: rk set", "success: rk = hello world",
                       help_, help_, "error: list index out of range",
                       f"success: {none_key} = None"]


def test_cli_client_tester_and_bench(cluster, capsys):
    from summerset_tpu_torch.cli import client as cli

    addr = "%s:%d" % cluster.manager_addr
    # the suite above left "job" written, so not primitive_ops here
    cli.main(["-u", "tester", "-m", addr, "--tests", "client_reconnect"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {"client_reconnect": "PASS"}
    cli.main(["-u", "bench", "-m", addr, "--secs", "1", "--freq", "50"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["acked"] > 0
    cli.main(["-u", "mess", "-m", addr, "--write", "mk=mv"])
    ep = GenericEndpoint(cluster.manager_addr)
    ep.connect()
    try:
        from summerset_tpu_torch.client.drivers import DriverClosedLoop

        DriverClosedLoop(ep).checked_get("mk", expect="mv")
    finally:
        ep.leave()


def test_bench_helpers_equal_jax(tmp_path):
    for spec in ("128", "0:64/2.5:1024", "3:8/1:16/0:4"):
        assert tbench.parse_value_schedule(spec) == \
            jbench.parse_value_schedule(spec)
    path = tmp_path / "run.log"
    path.write_text(
        "READ usertable user1 [ f ]\n"
        "UPDATE usertable user2 [ field0=abc ]\n"
        "INSERT usertable user3\n"
        "SCAN usertable user4 7 [ f ]\n"
        "SCAN usertable user5\n"
        "noise\n")
    assert tbench.load_ycsb_trace(str(path)) == \
        jbench.load_ycsb_trace(str(path))


@dataclasses.dataclass
class _Cfg:
    max_batch_size: int = 5000
    batch_interval_ms: float = 1.0
    logger_sync: bool = False
    backer_path: str = "x.wal"
    peers: list = dataclasses.field(default_factory=list)
    hint: object = None


@pytest.mark.parametrize("text", [
    None, "", "max_batch_size=10+logger_sync=true+backer_path='/a+b'",
    "batch_interval_ms=2", 'backer_path="q+r"+max_batch_size=7',
    "hint=3",
])
def test_config_round_trips_equal_jax(text):
    j = jconfig.parsed_config(_Cfg, text)
    t = tconfig.parsed_config(_Cfg, text)
    assert t == j
    assert tconfig.config_to_str(t) == jconfig.config_to_str(j)
    assert tconfig.parsed_config(_Cfg, tconfig.config_to_str(t)) == t
    assert tconfig._plus_to_newlines(text or "") == \
        jconfig._plus_to_newlines(text or "")


@pytest.mark.parametrize("text", [
    "nope=1", "max_batch_size='x'", "logger_sync=1", "max_batch_size=",
])
def test_config_refusals_equal_jax(text):
    with pytest.raises(Exception) as je:
        jconfig.parsed_config(_Cfg, text)
    with pytest.raises(SummersetError) as te:
        tconfig.parsed_config(_Cfg, text)
    assert str(te.value) == str(je.value)
    with pytest.raises(SummersetError):
        tconfig.parsed_config(int, "a=1")
