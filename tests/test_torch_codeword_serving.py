"""Live port clusters of the codeword family on the CPU: RSPaxos, CRaft
and Crossword served by three port ``ServerReplica`` threads at 2 groups
(the shapes of ``tests/test_codeword_plane.py::TestClusterCodewordPlane``
and ``tests/test_cluster.py::TestClusterRSFamily``).

- the proposing leader's payload-plane egress per value is shard-sized:
  below 0.75x of a MultiPaxos cluster's full copies for the same workload
  (measured on the replica that proposed the workload, and over the shard
  sends only: a codeword replica meters the full copies it also sends,
  CRaft's fallback and need-serves, apart in ``full_bytes``);
- a durable reset of the leader: every acknowledged key reads back, and
  the restarted replica's shard store holds every value its WAL ``cw``
  records logged;
- put/get and a durable reset of a follower, then put/get again.
"""

import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import read_wal  # noqa: E402

from summerset_tpu_torch.client.drivers import DriverClosedLoop  # noqa: E402
from summerset_tpu_torch.cluster import Cluster  # noqa: E402

torch.set_num_threads(1)

VALUE = "x" * 3000
KEYS = 8
GROUPS = 2
#: commit at a majority (RS(2,1) at R=3); Crossword's width pinned to
#: its diagonal so the shard sizes are deterministic (as the JAX test)
CW_CFG = {"fault_tolerance": 0, "hear_timeout_lo": 10,
          "hear_timeout_hi": 20}


def _cluster(protocol, tmpdir, config=None):
    c = Cluster(protocol, 3, tmpdir, num_groups=GROUPS, window=32,
                config=config, device="cpu")
    c.manager.settle_delay = 0.2
    return c


def _workload(cluster, prefix):
    ep = cluster.endpoint()
    try:
        drv = DriverClosedLoop(ep, timeout=3.0)
        for i in range(KEYS):
            drv.checked_put(f"{prefix}{i}", VALUE + str(i), retries=40)
    finally:
        ep.leave()


def _read_back(cluster, prefix):
    ep = cluster.endpoint()
    try:
        drv = DriverClosedLoop(ep, timeout=3.0)
        for i in range(KEYS):
            drv.checked_get(f"{prefix}{i}", VALUE + str(i), retries=60)
    except AssertionError as e:
        raise AssertionError(f"{e}\n{_dumps(cluster)}") from e
    finally:
        ep.leave()


def _dumps(cluster):
    return {me: rep.debug_state()
            for me, rep in sorted(cluster.replicas.items())}


def _leader(cluster, g=0, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        me = cluster.leader_of(g)
        if me is not None:
            return me
        time.sleep(0.1)
    raise AssertionError(f"no leader of group {g}: {_dumps(cluster)}")


def _per_item(rep):
    return sum(rep.pp_bytes) / max(1, sum(rep.pp_items))


def _proposer(cluster):
    """The replica that sent the most payloads: the workload's leader.
    Under CPU load a starved replica thread can lose an election after
    the workload, so the group's current leader may have proposed
    nothing of it."""
    return max(cluster.replicas.values(),
               key=lambda rep: (sum(rep.pp_items), -rep.me))


@pytest.fixture(scope="module")
def mp_baseline(tmp_path_factory):
    """The MultiPaxos leader's bytes per full-copy payload for the same
    workload (one cluster shared by the three classes)."""
    c = _cluster("MultiPaxos", tmp_path_factory.mktemp("cw_mp"),
                 {"hear_timeout_lo": 10, "hear_timeout_hi": 20})
    try:
        _workload(c, "cwb")
        rep = _proposer(c)
        assert sum(rep.pp_bytes) > 2 * KEYS * len(VALUE), rep.pp_bytes
        out = _per_item(rep)
    finally:
        c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"
    return out


@pytest.fixture(scope="class", params=["RSPaxos", "CRaft", "Crossword"])
def cw_cluster(request, tmp_path_factory):
    cfg = dict(CW_CFG)
    if request.param == "Crossword":
        cfg["assignment_adaptive"] = False
    c = _cluster(request.param,
                 tmp_path_factory.mktemp(f"cw_{request.param.lower()}"), cfg)
    yield c
    c.stop()
    assert not c.faults(), f"replica faults: {c.faults()}"


class TestTorchCodewordServing:
    def test_put_get_with_shard_sized_frames(self, cw_cluster, mp_baseline):
        _workload(cw_cluster, "cwk")
        _read_back(cw_cluster, "cwk")
        rep = _proposer(cw_cluster)
        assert rep.codewords is not None and sum(rep.pp_items) > 0
        # a shard send carries ~batch/d plus parity and framing: strictly
        # below 0.75x of a full copy at d = 2
        avg = _per_item(rep)
        assert 0.2 * mp_baseline < avg < 0.75 * mp_baseline, (
            f"{cw_cluster.protocol} bytes/payload {avg:.0f} vs MultiPaxos "
            f"{mp_baseline:.0f}: not shard-sized")

    def test_leader_reset_reads_back_and_rebuilds_store(self, cw_cluster):
        _workload(cw_cluster, "cwx")
        leader = _leader(cw_cluster)
        rep = cw_cluster.ctrl("reset_servers", servers=[leader],
                              durable=True)
        assert rep.done == [leader]
        time.sleep(1.0)
        _read_back(cw_cluster, "cwx")
        # the restarted replica's store holds what its WAL's cw records
        # logged (replayed at recovery)
        logged = {(g, vid) for e in read_wal(os.path.join(
            cw_cluster.tmpdir, f"r{leader}.wal"))
            if e[0] == "vote" for g in [e[1]] for vid in e[2].get("cw", {})}
        assert logged, "the leader logged no shard rows"
        deadline = time.monotonic() + 30
        while leader not in cw_cluster.replicas:
            assert time.monotonic() < deadline, "the reset leader is gone"
            time.sleep(0.1)
        store = cw_cluster.replicas[leader].codewords
        missing = [k for k in logged if not store.have_mask(*k)]
        assert not missing, missing[:8]

    def test_follower_reset_then_put_get(self, cw_cluster):
        _workload(cw_cluster, "cwf")
        leader = _leader(cw_cluster)
        # the lowest-numbered follower, replica 0 once an earlier case
        # moved leadership: a Raft-family replica restarting into a term
        # another replica won comes back a follower (the port's restore
        # rule; the JAX kernel keeps the warm-start leader flag)
        follower = min(me for me in cw_cluster.replicas if me != leader)
        rep = cw_cluster.ctrl("reset_servers", servers=[follower],
                              durable=True)
        assert rep.done == [follower]
        time.sleep(1.0)
        _read_back(cw_cluster, "cwf")
        _workload(cw_cluster, "cwg")
        _read_back(cw_cluster, "cwg")
