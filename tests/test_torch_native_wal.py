"""The port's native WAL (``summerset_tpu_torch/csrc/wal.cpp``, built with
``g++`` at first use) against its Python mirror ``_PyWal`` and the JAX
package's native WAL (``summerset_tpu/native/wal.cpp``), on the CPU.

One seeded record stream (vote rows, apply records, EPaxos exec records,
a snapshot marker; plain values, so the pickled bodies carry no package
class path) goes through each backend's ``StorageHub``: the three files
are byte-identical, each backend reads back every file the others wrote,
and a torn tail reads as the end of the log in all three.
"""

import hashlib
import os

import numpy as np
import pytest

from summerset_tpu.host.storage import LogAction as JLogAction
from summerset_tpu.host.storage import StorageHub as JStorageHub
from summerset_tpu_torch.host import storage as tstorage
from summerset_tpu_torch.host.storage import LogAction, StorageHub
from summerset_tpu_torch.ops import native

SEED = 7


def record_stream(seed=SEED, n=60):
    """WAL records of every shape the server writes, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = [("snap_floor", [int(x) for x in rng.integers(0, 50, 4)])]
    for i in range(n):
        g = int(rng.integers(0, 4))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(("vote", g, {
                "bal_max": int(rng.integers(0, 1 << 20)),
                "vote_bar": int(rng.integers(0, 64)),
                "win_bal": [int(x) for x in rng.integers(0, 9, 16)],
                "pp": {int(rng.integers(1, 999)): [
                    (int(rng.integers(0, 99)), "req", i,
                     ("put", f"k{i}", "v" * int(rng.integers(0, 300))))]},
            }))
        elif kind == 1:
            out.append((g, i, int(rng.integers(1, 999)),
                        None if rng.integers(0, 4) == 0 else
                        [(3, "req", i, ("get", f"k{i % 5}", None))]))
        else:
            out.append(("eapply", g, int(rng.integers(0, 3)), i,
                        int(rng.integers(1, 999)), None))
    return out


def _write(hub, action_cls, records, sync_every=7):
    for i, rec in enumerate(records):
        res = hub.do_sync_action(action_cls(
            "append", entry=rec, sync=(i % sync_every == 0)))
        assert res.end_offset == hub.size
    hub.do_sync_action(action_cls("sync"))
    hub.stop()


def _read(hub, action_cls):
    out, off = [], 0
    try:
        while True:
            res = hub.do_sync_action(action_cls("read", offset=off))
            if not res.offset_ok or res.entry is None:
                return out, off
            out.append(res.entry)
            off = res.end_offset
    finally:
        hub.stop()


BACKENDS = {
    "torch_native": lambda p: StorageHub(p),
    "torch_py": lambda p: StorageHub(p, prefer_native=False),
    "jax_native": lambda p: JStorageHub(p, prefer_native=True),
}
ACTIONS = {"torch_native": LogAction, "torch_py": LogAction,
           "jax_native": JLogAction}


@pytest.fixture(scope="module")
def wal_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("native_wal")
    recs = record_stream()
    paths = {}
    for name, make in BACKENDS.items():
        p = str(base / f"{name}.wal")
        hub = make(p)
        if name != "torch_py":
            assert hub.native, f"{name} did not open its native backend"
        _write(hub, ACTIONS[name], recs)
        paths[name] = p
    return recs, paths


def test_port_hub_opens_native_built_in_build_dir(tmp_path):
    hub = StorageHub(str(tmp_path / "a.wal"))
    try:
        assert hub.native and isinstance(hub.backend, tstorage._NativeWal)
    finally:
        hub.stop()
    py = StorageHub(str(tmp_path / "b.wal"), prefer_native=False)
    try:
        assert not py.native and isinstance(py.backend, tstorage._PyWal)
    finally:
        py.stop()
    # built from the checkout's source into _build/, under a name that
    # carries a hash of the source and the g++ flags
    path = native.build("wal")
    assert os.path.dirname(path) == native.BUILD_DIR
    with open(os.path.join(native.CSRC_DIR, "wal.cpp"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(native.CXX_FLAGS).encode())
    assert os.path.basename(path) == f"libwal_{h.hexdigest()[:12]}.so"
    assert "-O2" in native.CXX_FLAGS and "-fPIC" in native.CXX_FLAGS


def test_three_backends_write_byte_identical_files(wal_files):
    _recs, paths = wal_files
    blobs = {name: open(p, "rb").read() for name, p in paths.items()}
    assert blobs["torch_native"] == blobs["torch_py"] == blobs["jax_native"]
    assert len(blobs["torch_native"]) > 1000


@pytest.mark.parametrize("reader", sorted(BACKENDS))
@pytest.mark.parametrize("writer", sorted(BACKENDS))
def test_each_backend_recovers_the_others_files(wal_files, tmp_path,
                                                writer, reader):
    recs, paths = wal_files
    copy = str(tmp_path / "copy.wal")
    with open(paths[writer], "rb") as f, open(copy, "wb") as g:
        g.write(f.read())
    got, end = _read(BACKENDS[reader](copy), ACTIONS[reader])
    assert got == recs
    assert end == os.path.getsize(copy)


@pytest.mark.parametrize("reader", sorted(BACKENDS))
def test_torn_tail_reads_as_the_end(wal_files, tmp_path, reader):
    recs, paths = wal_files
    data = open(paths["torch_native"], "rb").read()
    torn = str(tmp_path / "torn.wal")
    with open(torn, "wb") as g:
        g.write(data[:-5])  # the last record cut mid-body
    got, end = _read(BACKENDS[reader](torn), ACTIONS[reader])
    assert got == recs[:-1]
    assert end < len(data) - 5


def test_truncate_and_append_after_reopen(tmp_path):
    """The recovery path's torn-tail truncate, then appends landing right
    after it, on the native backend and the mirror alike."""
    recs = record_stream(seed=11, n=10)
    blobs = {}
    for name in ("torch_native", "torch_py"):
        p = str(tmp_path / f"{name}.wal")
        _write(BACKENDS[name](p), LogAction, recs)
        hub = BACKENDS[name](p)
        ends = []
        off = 0
        for _ in range(4):
            res = hub.do_sync_action(LogAction("read", offset=off))
            off = res.end_offset
            ends.append(off)
        res = hub.do_sync_action(LogAction("truncate", offset=ends[-1],
                                           sync=True))
        assert res.offset_ok and res.now_size == ends[-1]
        hub.do_sync_action(LogAction("append", entry=("tail", 1),
                                     sync=True))
        hub.stop()
        got, _ = _read(BACKENDS[name](p), LogAction)
        assert got == recs[:4] + [("tail", 1)]
        blobs[name] = open(p, "rb").read()
    assert blobs["torch_native"] == blobs["torch_py"]
