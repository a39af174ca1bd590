"""The port's snapshot recovery decision table, the cases of
``tests/test_longlived.py::TestSnapshotRecoveryDecision`` on the port's
``ServerReplica`` (built by its own constructor, which runs
``_recover_from_snapshot`` then ``_recover_from_wal``; no sockets):

- an unreadable snapshot beside a COMPACTED WAL (``snap_floor`` marker
  first) is fatal: the apply history below the floor lives only in the
  snapshot;
- an unreadable snapshot beside a FULL WAL is ignored: the replay alone
  rebuilds everything;
- a readable snapshot with the marker reconciles the floors;
- no snapshot file is a first boot, not an unreadable snapshot;
- a missing or stale snapshot beside a compacted WAL is fatal.

This module imports nothing of JAX.
"""

import os
import pickle
import sys

import pytest
import torch

from summerset_tpu_torch.host import server as tsrv
from summerset_tpu_torch.host.messages import ApiRequest
from summerset_tpu_torch.host.statemach import Command
from summerset_tpu_torch.host.storage import LogAction, StorageHub
from summerset_tpu_torch.utils.errors import SummersetError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cluster import build  # noqa: E402

torch.set_num_threads(1)


def _put_batch(key, value, req_id=1):
    return [(7, ApiRequest("req", req_id=req_id,
                           cmd=Command("put", key, value)))]


def _wal(tmp_path, *entries):
    hub = StorageHub(os.path.join(str(tmp_path), "r0.wal"))
    try:
        for e in entries:
            res = hub.do_sync_action(LogAction("append", entry=e, sync=True))
            assert res.offset_ok
    finally:
        hub.stop()


def _snap(tmp_path, obj=None, raw=None):
    with open(os.path.join(str(tmp_path), "r0.snap"), "wb") as f:
        if raw is not None:
            f.write(raw)
        else:
            pickle.dump(obj, f)


def _replica(tmp_path):
    return build(tsrv, "MultiPaxos", 0, 3, 1, 32, tmp_path, {},
                 device="cpu")


class TestTorchSnapshotRecoveryDecision:
    def test_unreadable_snapshot_with_compacted_wal_is_fatal(self, tmp_path):
        _wal(tmp_path, ("snap_floor", [5]))
        _snap(tmp_path, raw=b"\x80garbage not a pickle")
        with pytest.raises(SummersetError, match="compacted"):
            _replica(tmp_path)

    def test_unreadable_snapshot_with_full_wal_proceeds(self, tmp_path):
        _wal(tmp_path, (0, 0, 1, _put_batch("k", "v1")),
             (0, 1, 2, _put_batch("k", "v2")))
        _snap(tmp_path, raw=b"\x80garbage not a pickle")
        rep = _replica(tmp_path)
        try:
            assert rep._snap_unreadable is not None
            assert rep.statemach._kv["k"] == "v2"
            assert rep.applied[0] == 2
        finally:
            rep.shutdown()

    def test_readable_snapshot_with_marker_reconciles_floors(self, tmp_path):
        _snap(tmp_path, ("kv", {"k": "snapval"},
                         {"applied": [5], "wslots": {"k": 4}}))
        # a post-snapshot apply record above the floor still replays
        _wal(tmp_path, ("snap_floor", [5]),
             (0, 5, 9, _put_batch("k2", "late")))
        rep = _replica(tmp_path)
        try:
            assert rep._snap_unreadable is None
            assert rep.statemach._kv["k"] == "snapval"
            assert rep.statemach._kv["k2"] == "late"
            assert rep.applied[0] == 6
            assert rep._wslot == {"k": 4, "k2": 5}
        finally:
            rep.shutdown()

    def test_missing_snapshot_is_not_unreadable(self, tmp_path):
        rep = _replica(tmp_path)  # no file at all: a first boot
        try:
            assert rep._snap_unreadable is None
            assert rep._snap_floors is None
        finally:
            rep.shutdown()

    def test_missing_snapshot_with_compacted_wal_is_fatal(self, tmp_path):
        """A lost snapshot file is as fatal as an unreadable one once the
        WAL is compacted (a crash where the compacted WAL's rename reached
        the disk and the snapshot's did not)."""
        _wal(tmp_path, ("snap_floor", [5]))
        with pytest.raises(SummersetError, match="missing"):
            _replica(tmp_path)

    def test_stale_snapshot_below_marker_floor_is_fatal(self, tmp_path):
        """A readable but older snapshot (floors below the marker's)
        cannot cover the discarded apply history either."""
        _snap(tmp_path, ("kv", {}, {"applied": [2], "wslots": {}}))
        _wal(tmp_path, ("snap_floor", [5]))
        with pytest.raises(SummersetError, match="stale"):
            _replica(tmp_path)
