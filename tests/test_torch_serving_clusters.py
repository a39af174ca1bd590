"""Live port clusters for the protocols and planes the port's
``ServerReplica`` serves beyond the MultiPaxos/Raft core, on the CPU: a
real manager and three replica threads over localhost TCP (the harness
of ``tests/test_torch_cluster.py``), in the shapes of the JAX package's
cluster tests:

- EPaxos (``tests/test_cluster.py::TestClusterEPaxos`` and
  ``TestClusterEPaxosMultiBucket``): two clients pinned to different
  replicas write and read interleaved keys, the history linearizes, a
  durable reset recovers through the ``eapply`` records; a burst of puts
  to distinct key buckets is proposed in one tick;
- SimplePush (``TestClusterBasics``): a durable reset of the serving
  node recovers its log, and it serves on;
- snapshots (``test_snapshot_gc_and_recovery`` and
  ``TestClusterAutoSnapshot``): a manager ``take_snapshot`` shrinks the
  WALs and every replica recovers from snapshot plus tail; an interval
  snapshot fires without a request and compacts the WAL.

This module imports nothing of JAX.
"""

import os
import sys
import threading
import time

import pytest
import torch

from summerset_tpu_torch.client.drivers import DriverClosedLoop
from summerset_tpu_torch.client.endpoint import GenericEndpoint
from summerset_tpu_torch.cluster import Cluster
from summerset_tpu_torch.utils.linearize import (
    check_history, record_get, record_put,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import card_cpu_serving_lockstep  # noqa: E402

torch.set_num_threads(1)


def _dumps(cluster):
    return {me: rep.debug_state()
            for me, rep in sorted(cluster.replicas.items())}


def _assert_recovers(cluster, expect, servers=None, pin=None):
    """A durable reset of ``servers`` (every replica by default), then
    every key of ``expect`` read back (at replica ``pin`` if given)."""
    rep = cluster.ctrl("reset_servers", servers=servers, durable=True)
    want = sorted(cluster.replicas) if servers is None else sorted(servers)
    assert sorted(rep.done) == want, rep
    time.sleep(1.0)
    ep = GenericEndpoint(cluster.manager_addr, server_id=pin)
    ep.connect()
    drv = DriverClosedLoop(ep, timeout=5.0)
    try:
        for key, val in expect.items():
            drv.checked_get(key, expect=val)
    except AssertionError as e:
        raise AssertionError(f"{e}\nreplica states: {_dumps(cluster)}")
    finally:
        ep.leave()


# ------------------------------------------------------------------ EPaxos
@pytest.fixture(scope="class")
def ep_cluster(tmp_path_factory):
    c = Cluster("EPaxos", 3, tmp_path_factory.mktemp("torch_epaxos"),
                num_groups=2, window=32, device="cpu")
    yield c
    c.stop()
    assert not c.faults(), c.faults()


class TestTorchClusterEPaxos:
    def test_multi_leader_history_and_reset(self, ep_cluster):
        """Two clients pinned to different replicas write and read two
        keys interleaved: both replicas propose (no leader), the history
        is linearizable, and a durable reset of replica 0 recovers an
        acknowledged put through its ``eapply`` records."""
        ops = []

        def worker(ci, sid, n):
            ep = GenericEndpoint(ep_cluster.manager_addr, server_id=sid)
            ep.connect()
            drv = DriverClosedLoop(ep, timeout=5.0)
            for seq in range(n):
                key = f"ep{seq % 2}"
                t0 = time.monotonic()
                if seq % 2 == ci % 2:
                    val = f"c{ci}-{seq}"
                    rep = drv.put(key, val)
                    t1 = time.monotonic()
                    if rep.kind == "success":
                        ops.append(record_put(ci, key, val, t0, t1, True))
                    elif rep.kind in ("timeout", "failure", "disconnect"):
                        ops.append(record_put(ci, key, val, t0, None,
                                              False))
                else:
                    rep = drv.get(key)
                    t1 = time.monotonic()
                    if rep.kind == "success":
                        val = rep.result.value if rep.result else None
                        ops.append(record_get(ci, key, val, t0, t1))
            ep.leave()

        threads = [threading.Thread(target=worker, args=(ci, sid, 12),
                                    daemon=True)
                   for ci, sid in enumerate((0, 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(ops) > 12, f"history too small: {len(ops)}"
        ok, diag = check_history(ops)
        assert ok, diag
        # both pinned replicas proposed into their own rows
        for sid in (0, 1):
            assert ep_cluster.replicas[sid].origin, sid

        ep = GenericEndpoint(ep_cluster.manager_addr, server_id=1)
        ep.connect()
        DriverClosedLoop(ep).checked_put("ep_stable", "keep")
        ep.leave()
        _assert_recovers(ep_cluster, {"ep_stable": "keep"}, servers=[0],
                         pin=0)

    def test_mixed_key_batch_proposes_in_one_tick(self, ep_cluster):
        """A concurrent burst of puts to distinct key buckets of one
        group at one replica is proposed in one tick: one vid per bucket
        in the same ``prop_vids`` list."""
        srv = ep_cluster.replicas[0]
        keys, i = [], 0
        while len(keys) < 4:
            k = f"mb{i}"
            i += 1
            if srv.group_of(k) == 0 and srv._key_bucket(k) not in {
                    srv._key_bucket(x) for x in keys}:
                keys.append(k)
        seen = []

        def wrap(rep):
            orig = rep._intake_epaxos

            def wrapped(by_group, n_prop, vbase, piggy):
                out = orig(by_group, n_prop, vbase, piggy)
                nz = int((rep._ep_prop_vids != 0).sum(axis=1).max())
                if nz:
                    seen.append(nz)
                return out

            rep._intake_epaxos = wrapped

        wrap(srv)
        # pre-connected endpoints, so the burst threads only issue puts
        eps = []
        for _ in keys:
            e = GenericEndpoint(ep_cluster.manager_addr, server_id=0)
            e.connect()
            eps.append(e)
        for _attempt in range(3):
            seen.clear()
            barrier = threading.Barrier(len(keys))

            def put(e, k, attempt=_attempt):
                barrier.wait()
                DriverClosedLoop(e, timeout=5.0).checked_put(
                    k, f"v{attempt}-{k}")

            threads = [threading.Thread(target=put, args=(e, k),
                                        daemon=True)
                       for e, k in zip(eps, keys)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            if seen and max(seen) >= 2:
                break
        for e in eps:
            e.leave()
        assert seen and max(seen) >= 2, seen
        ep = GenericEndpoint(ep_cluster.manager_addr, server_id=2)
        ep.connect()
        drv = DriverClosedLoop(ep, timeout=5.0)
        for k in keys:
            drv.checked_get(k, expect=f"v{_attempt}-{k}")
        ep.leave()


# -------------------------------------------------------------- SimplePush
@pytest.fixture(scope="class")
def sp_cluster(tmp_path_factory):
    c = Cluster("SimplePush", 3, tmp_path_factory.mktemp("torch_sp"),
                device="cpu")
    yield c
    c.stop()
    assert not c.faults(), c.faults()


class TestTorchClusterBasics:
    def test_simple_push_serving_node_restart(self, sp_cluster):
        """SimplePush pushes batches to its peers and replies; a durable
        reset of the serving node recovers its log from the WAL, and it
        serves on."""
        ep = sp_cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=5.0)
        for i in range(5):
            drv.checked_put(f"spk{i}", f"v{i}")
        ep.leave()
        _assert_recovers(sp_cluster, {f"spk{i}": f"v{i}" for i in range(5)},
                         servers=[0])
        ep = sp_cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=5.0)
        drv.checked_put("spk_post", "after")
        drv.checked_get("spk_post", expect="after")
        ep.leave()


# --------------------------------------------------------------- snapshots
@pytest.fixture(scope="class")
def snap_cluster(tmp_path_factory):
    c = Cluster("MultiPaxos", 3, tmp_path_factory.mktemp("torch_snap"),
                num_groups=2, config={"hear_timeout_lo": 10,
                                      "hear_timeout_hi": 20}, device="cpu")
    yield c
    c.stop()
    assert not c.faults(), c.faults()


class TestTorchClusterSnapshot:
    def test_snapshot_gc_and_recovery(self, snap_cluster):
        """Writes grow the WALs; a ``take_snapshot`` through the manager is
        answered by every replica and shrinks the WALs; every replica then
        restarts from snapshot plus WAL tail and serves every value."""
        ep = snap_cluster.endpoint()
        drv = DriverClosedLoop(ep, timeout=5.0)
        for i in range(12):
            drv.checked_put(f"snapk{i}", f"v{i}")
        ep.leave()
        time.sleep(1.0)  # followers apply and log the tail
        before = {me: rep.wal.size
                  for me, rep in snap_cluster.replicas.items()}
        rep = snap_cluster.ctrl("take_snapshot")
        assert sorted(rep.done) == sorted(before), rep
        after = {me: r.wal.size for me, r in snap_cluster.replicas.items()}
        assert any(after[me] < before[me] for me in after), (before, after)
        for me in after:
            assert os.path.exists(os.path.join(snap_cluster.tmpdir,
                                               f"r{me}.snap"))
        _assert_recovers(snap_cluster,
                         {f"snapk{i}": f"v{i}" for i in range(12)})


@pytest.fixture(scope="class")
def autosnap_cluster(tmp_path_factory):
    c = Cluster("MultiPaxos", 3, tmp_path_factory.mktemp("torch_autosnap"),
                config={"snapshot_interval": 60, "hear_timeout_lo": 10,
                        "hear_timeout_hi": 20}, device="cpu")
    yield c
    c.stop()
    assert not c.faults(), c.faults()


class TestTorchClusterAutoSnapshot:
    def test_interval_snapshot_compacts_wal(self, autosnap_cluster):
        """``snapshot_interval``: with no request, a snapshot fires once
        writes applied, the WAL compacts, and a restart of every replica
        recovers from snapshot plus tail.  Files are probed, not the live
        hub, which the replica swaps mid-snapshot."""
        c = autosnap_cluster
        ep = c.endpoint()
        drv = DriverClosedLoop(ep, timeout=5.0)
        t_base = time.time()
        for i in range(15):
            drv.checked_put(f"ask{i}", f"v{i}")
        ep.leave()
        snaps = [os.path.join(c.tmpdir, f"r{me}.snap") for me in c.replicas]
        deadline = time.monotonic() + 20
        fired = False
        while time.monotonic() < deadline and not fired:
            time.sleep(0.3)
            fired = all(os.path.exists(p) and os.path.getmtime(p) > t_base
                        for p in snaps)
        assert fired, f"no interval snapshot fired: {snaps}"
        wals = sorted(os.path.getsize(os.path.join(c.tmpdir, f"r{me}.wal"))
                      for me in c.replicas)
        assert wals[0] < 32 * 1024, f"WALs not compacted: {wals}"
        _assert_recovers(c, {f"ask{i}": f"v{i}" for i in range(15)})


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_two_port_trios_agree_in_lockstep(tmp_path, pipelined):
    """The card-against-CPU gate of ``chip_smoke.py`` phase 17, with both
    trios on the CPU: two port EPaxos trios step the same ticks through a
    durable reset and agree on every part, with a multi-bucket tick."""
    out = card_cpu_serving_lockstep(tmp_path, "cpu", "EPaxos",
                                    pipelined=pipelined, G=4)
    assert out["acked"] > 10 and out["multi"] >= 2, out
    assert out["ep_exec_us"] is not None
