"""The port's pipelined tick loop: the durability fence and the loop-mode
A/B, counterpart of ``tests/test_pipeline.py``.

No vote/ack computed by step N may leave the process — peer tick frame
or client reply — before step N's WAL records are fsynced, and a failed
fsync must crash the replica with everything gated on the fence still
unsent.  Pinned at three scales: the ``StorageHub`` background group
commit (tokens, sticky error latching), the egress seams
(``TransportHub.send_tick`` and ``ExternalApi.send_replies`` run the
fence before the first byte), and live 1-replica port clusters on the
CPU (an injected fsync failure and a torn append each crash the replica
before any ack; both loop modes land the same durable state; stage
labels are honest).
"""

import hashlib
import os
import sys

import pytest

from summerset_tpu_torch.host.storage import LogAction, StorageHub
from summerset_tpu_torch.utils.errors import SummersetError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- storage --
class TestBackgroundGroupCommit:
    def test_token_covers_prior_appends(self, tmp_path):
        hub = StorageHub(str(tmp_path / "a.wal"))
        try:
            for i in range(8):
                hub.append_nowait(("e", i))
            tok = hub.flush_token()
            hub.wait_flush(tok, timeout=10.0)
            assert hub.backend.size > 0
            entries, off = [], 0
            while True:
                res = hub.do_sync_action(LogAction("read", offset=off))
                if not res.offset_ok or res.entry is None:
                    break
                entries.append(res.entry)
                off = res.end_offset
            assert entries == [("e", i) for i in range(8)]
        finally:
            hub.stop()

    def test_tokens_are_monotonic_and_reusable(self, tmp_path):
        hub = StorageHub(str(tmp_path / "b.wal"))
        try:
            hub.append_nowait("x")
            t1 = hub.flush_token()
            hub.append_nowait("y")
            t2 = hub.flush_token()
            assert t2 > t1
            hub.wait_flush(t2, timeout=10.0)
            hub.wait_flush(t1, timeout=0.1)
        finally:
            hub.stop()

    def test_fsync_failure_raises_at_fence_and_latches(self, tmp_path):
        hub = StorageHub(str(tmp_path / "c.wal"))
        try:
            hub.append_nowait("doomed")
            hub.set_faults({"fsync_fail": 1})
            tok = hub.flush_token()
            with pytest.raises(SummersetError, match="group commit"):
                hub.wait_flush(tok, timeout=10.0)
            # sticky: a fresh token cannot outrun the latched error
            hub.set_faults(None)
            tok2 = hub.flush_token()
            with pytest.raises(SummersetError, match="group commit"):
                hub.wait_flush(tok2, timeout=10.0)
            with pytest.raises(SummersetError, match="group commit"):
                hub.poll_flush(tok2)
        finally:
            hub.stop()

    def test_failed_background_append_surfaces_at_next_fence(
        self, tmp_path
    ):
        hub = StorageHub(str(tmp_path / "d.wal"))
        try:
            hub.set_faults({"torn": 1})
            hub.append_nowait("torn-victim")
            tok = hub.flush_token()
            with pytest.raises(SummersetError, match="group commit"):
                hub.wait_flush(tok, timeout=10.0)
        finally:
            hub.stop()

    def test_wait_flush_timeout_is_typed(self, tmp_path):
        hub = StorageHub(str(tmp_path / "e.wal"))
        try:
            with pytest.raises(SummersetError, match="timed out"):
                hub.wait_flush(10_000, timeout=0.05)
        finally:
            hub.stop()


# ------------------------------------------------------------ egress seams --
class TestFenceGatesEgress:
    def test_send_replies_runs_fence_before_first_reply(self):
        from summerset_tpu_torch.host.external import ExternalApi

        api = ExternalApi.__new__(ExternalApi)
        calls = []
        api.send_reply = lambda reply, client: calls.append(
            ("reply", client)
        )
        api.send_replies(
            [(1, "r1"), (2, "r2")],
            fence=lambda: calls.append(("fence",)),
        )
        assert calls == [("fence",), ("reply", 1), ("reply", 2)]

    def test_send_replies_raising_fence_sends_nothing(self):
        from summerset_tpu_torch.host.external import ExternalApi

        api = ExternalApi.__new__(ExternalApi)
        sent = []
        api.send_reply = lambda reply, client: sent.append(client)

        def bad_fence():
            raise SummersetError("fsync failed")

        with pytest.raises(SummersetError):
            api.send_replies([(1, "r1"), (2, "r2")], fence=bad_fence)
        assert sent == []

    def test_send_tick_raising_fence_sends_no_frame(self):
        import socket

        from summerset_tpu_torch.host.transport import TransportHub

        a, b = socket.socketpair()
        hub = TransportHub.__new__(TransportHub)
        hub._conns = {1: a}

        def bad_fence():
            raise SummersetError("fsync failed")

        with pytest.raises(SummersetError):
            hub.send_tick(7, {1: {"msg": {}}}, fence=bad_fence)
        b.setblocking(False)
        with pytest.raises(BlockingIOError):
            b.recv(1)  # nothing escaped
        a.close()
        b.close()


# --------------------------------------------------------------- live loop --
def _mk_cluster(tmpdir, config=None):
    from summerset_tpu_torch.cluster import Cluster

    return Cluster("MultiPaxos", 1, str(tmpdir), config=config or {},
                   tick=0.004, num_groups=2, settle=0.5, device="cpu")


def _driver(cluster, timeout=20.0):
    from summerset_tpu_torch.client.drivers import DriverClosedLoop

    ep = cluster.endpoint()
    return ep, DriverClosedLoop(ep, timeout=timeout)


def _wait_crash(c, secs=30.0):
    import time

    deadline = time.monotonic() + secs
    while not c.crash_reports and time.monotonic() < deadline:
        time.sleep(0.1)
    assert c.crash_reports, "replica should have crashed"


class TestFenceCrashSafety:
    def test_fsync_failure_is_fatal_before_any_ack(self, tmp_path):
        c = _mk_cluster(tmp_path)
        ep = None
        try:
            ep, drv = _driver(c)
            drv.checked_put("pre", "durable")
            rep = c.replicas[0]
            assert rep.pipeline  # the default mode under test
            rep.wal.set_faults({"fsync_fail": 2})
            # the write's records hit the failing group commit: the
            # fence raises before the reply leaves and the replica
            # crashes; the single attempt fails client-side
            r = drv.put("k", "v1")
            assert r.kind != "success"
            _wait_crash(c)
            assert "group commit" in c.crash_reports[0]["error"]
            # after the restart the acked prefix survived, and the op is
            # only ever acked once recovery made it durable
            drv.checked_put("k", "v2")
            g = drv.get("pre")
            assert g.kind == "success" and g.result.value == "durable"
        finally:
            if ep is not None:
                ep.leave()
            c.stop()

    def test_torn_background_append_is_fatal_before_any_ack(
        self, tmp_path
    ):
        c = _mk_cluster(tmp_path)
        ep = None
        try:
            ep, drv = _driver(c)
            drv.checked_put("pre", "durable")
            c.replicas[0].wal.set_faults({"torn": 1})
            r = drv.put("k", "v1")
            assert r.kind != "success"
            _wait_crash(c)
            # the restart truncated the tear; writes are served again
            drv.checked_put("post", "recovered")
            assert drv.get("post").result.value == "recovered"
            g = drv.get("pre")
            assert g.kind == "success" and g.result.value == "durable"
        finally:
            if ep is not None:
                ep.leave()
            c.stop()


_MODE_DIGESTS: dict = {}


class TestLoopModeEquivalence:
    """``pipeline=False`` is the strictly ordered serial loop: the same
    sequential history lands byte-identical durable state in both
    modes, and each mode's stage labels are honest."""

    @staticmethod
    def _durable_digest(rep) -> str:
        h = hashlib.sha256()
        ker = rep.kernel
        for k in sorted(tuple(ker.DURABLE_SCALARS)
                        + tuple(ker.DURABLE_WINDOWS)):
            h.update(k.encode())
            h.update(rep.state[k].numpy().tobytes())
        return h.hexdigest()

    @pytest.mark.parametrize("pipeline", [False, True])
    def test_same_history_same_applied_state(self, tmp_path, pipeline):
        c = _mk_cluster(tmp_path, config={"pipeline": pipeline})
        ep = None
        try:
            ep, drv = _driver(c)
            for i in range(24):
                drv.checked_put(f"k{i % 7}", f"v{i}")
            rep = c.replicas[0]
            assert rep.pipeline is pipeline
            assert sum(rep.applied) == 24
            assert dict(rep.statemach.snapshot_items()) == {
                f"k{j}": f"v{max(i for i in range(24) if i % 7 == j)}"
                for j in range(7)
            }
            seen = _MODE_DIGESTS.setdefault("seq24", {})
            seen[pipeline] = self._durable_digest(rep)
            if len(seen) == 2:
                assert seen[True] == seen[False]
            # the serial loop never emits the pipeline stages, the
            # pipelined loop never emits the fused step stage
            hist = rep.metrics.hist("loop_stage_us", stage="overlap")
            wait = rep.metrics.hist("loop_stage_us", stage="device_wait")
            step = rep.metrics.hist("loop_stage_us", stage="step")
            if pipeline:
                assert hist is not None and hist.count > 0
                assert wait is not None and wait.count > 0
                assert step is None
            else:
                assert hist is None and wait is None
                assert step is not None and step.count > 0
        finally:
            if ep is not None:
                ep.leave()
            c.stop()


class TestPipelineFlush:
    def test_graceful_stop_settles_inflight_step(self, tmp_path):
        c = _mk_cluster(tmp_path)
        ep = None
        try:
            ep, drv = _driver(c)
            for i in range(6):
                drv.checked_put(f"s{i}", str(i))
            rep = c.replicas[0]
            assert rep.wal.backend.size > 0
        finally:
            if ep is not None:
                ep.leave()
            c.stop()
        # the stop path ran _pipeline_flush: no in-flight registers left
        assert rep._pl is None
        assert rep._fence_token is None
        assert rep._reply_queue == []
