"""The port's workload plane (``summerset_tpu_torch/host/workload.py``)
against the JAX package's, and an overload run on a port cluster.

Plans and streams are pure functions of the seed, so every comparison
is exact: ``timeline()``, ``digest()`` and ``horizon()`` byte for byte,
``rate_x_at`` on a tick grid, and the first 200 ops of 4 clients' op
streams.  A trace file written here goes through both ``from_trace``.
The live case plays a ``hot_burst`` plan through
``start_workload_clients`` against a port cluster with a small ingress
queue: sheds show on the scrape, and the recorded history (shed puts as
negative acks) is linearizable.
"""

import threading
import time

import pytest
import torch

from summerset_tpu.host import workload as jwl
from summerset_tpu_torch.host import workload as twl

torch.set_num_threads(1)

SEEDS = (1, 7, 42)
GENERATED = tuple(c for c in twl.WORKLOAD_CLASSES if c != "trace")

TRACE_ROWS = [
    "READ usertable user12 [ field0 ]",
    "UPDATE usertable user7 [ field1=abcdefghij ]",
    "INSERT usertable user99 [ field0=xyz field1=0123456789abcdef ]",
    "SCAN usertable user3 12 [ field0 ]",
    "progress: 3 ops done",
    "READ user5",
    "UPDATE user5 64",
    "SCAN user1 100",
    "bogus",
    "INSERT usertable user12 [ ]",
]


def _plans(cls, seed, tmp_path=None):
    if cls == "trace":
        return (jwl.WorkloadPlan.from_trace(TRACE_ROWS, seed, clients=4),
                twl.WorkloadPlan.from_trace(TRACE_ROWS, seed, clients=4))
    return (jwl.WorkloadPlan.generate(seed, cls, clients=4),
            twl.WorkloadPlan.generate(seed, cls, clients=4))


def test_class_table_matches_jax():
    assert twl.WORKLOAD_CLASSES == jwl.WORKLOAD_CLASSES
    assert len(twl.WORKLOAD_CLASSES) == 8


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cls", twl.WORKLOAD_CLASSES)
def test_plans_equal_jax(cls, seed):
    j, t = _plans(cls, seed)
    assert t.timeline() == j.timeline()
    assert t.digest() == j.digest()
    assert t.horizon() == j.horizon()
    grid = [x * 0.5 for x in range(-2, 2 * j.horizon() + 6)]
    assert [t.rate_x_at(x) for x in grid] == [j.rate_x_at(x) for x in grid]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cls", twl.WORKLOAD_CLASSES)
def test_op_streams_equal_jax(cls, seed):
    """The first 200 ops of each of 4 clients."""
    j, t = _plans(cls, seed)
    for ci in range(4):
        js, ts = j.opstream(ci), t.opstream(ci)
        assert ts.keys == js.keys
        assert [ts.next() for _ in range(200)] == \
            [js.next() for _ in range(200)]


def test_refusals_match_jax():
    for mod in (jwl, twl):
        with pytest.raises(ValueError):
            mod.WorkloadPlan.generate(1, "nope")
        with pytest.raises(ValueError):
            mod.WorkloadPlan.generate(1, "trace")
        with pytest.raises(ValueError):
            mod.WorkloadPlan.from_trace(["nothing here", "x"])


def test_trace_file_equal_jax(tmp_path):
    """A YCSB trace file written here: equal ``trace_sha``, rows and
    per-client ops through both packages' ``from_trace``."""
    path = tmp_path / "small.trace"
    path.write_text("\n".join(TRACE_ROWS * 3) + "\n")
    j = jwl.WorkloadPlan.from_trace(str(path), 5, clients=3)
    t = twl.WorkloadPlan.from_trace(str(path), 5, clients=3)
    assert t.trace_sha() == j.trace_sha()
    assert t.trace == j.trace and len(t.trace) == 24
    assert t.digest() == j.digest()
    for ci in range(3):
        js, ts = j.opstream(ci), t.opstream(ci)
        assert [ts.next() for _ in range(30)] == \
            [js.next() for _ in range(30)]


# ---------------------------------------------------------------- live run
BURST_TICK_S = 0.05           # wall seconds per workload tick (6 s plan)
BURST_CAP = 150.0             # offered ops/s at rate_x 1.0


def test_hot_burst_sheds_and_stays_linearizable(tmp_path):
    from summerset_tpu_torch.client.endpoint import scrape_metrics
    from summerset_tpu_torch.client.tester import start_workload_clients
    from summerset_tpu_torch.cluster import Cluster
    from summerset_tpu_torch.utils.linearize import check_history

    plan = twl.WorkloadPlan.generate(3, "hot_burst", clients=3,
                                     num_keys=8)
    cluster = Cluster("MultiPaxos", 3, tmp_path, num_groups=2,
                      config={"api_max_batch": 2, "api_max_pending": 6},
                      device="cpu")
    stop = threading.Event()
    ops, stats, threads = [], [], []
    try:
        t0 = time.monotonic()

        def rate_total_of():
            return plan.rate_x_at((time.monotonic() - t0) / BURST_TICK_S) \
                * BURST_CAP

        threads = start_workload_clients(cluster.manager_addr, plan,
                                         rate_total_of, stop, ops, stats,
                                         timeout=3.0)
        time.sleep(plan.horizon() * BURST_TICK_S)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        scrape = scrape_metrics(cluster.manager_addr)
        assert not cluster.faults(), cluster.faults()
    finally:
        stop.set()
        cluster.stop()
    shed = sum(s["host"]["counters"].get("api_shed", 0)
               for s in scrape.values())
    assert shed > 0, scrape
    assert sum(s["shed"] for s in stats) > 0, stats
    assert sum(s["acked"] for s in stats) > 20, stats
    assert any(o.kind == "put" and o.acked for o in ops)
    ok, diag = check_history(ops)
    assert ok, diag
