"""The port stands alone: importing ``summerset_tpu_torch`` (every module),
``chip_smoke`` and ``serve_upload_ab`` loads neither ``jax`` nor the JAX package, and no entry
point of the port falls back to the CPU by itself.  The wire codec and
the native WAL's loader, run (not only imported), load nothing of the JAX
package either, and a lane decoded as a view into a received frame never
reaches the device upload unchanged.

The import check runs in a subprocess, because ``tests/conftest.py``
imports jax into this one.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import summerset_tpu_torch as pkg
mods = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    mods.append(info.name)
import chip_smoke, serve_upload_ab
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "summerset_tpu" or m.startswith("summerset_tpu."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_and_chip_smoke_import_no_jax():
    proc = _run(["-c", _PROBE])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    # the walk really reached the kernel, protocol and host modules
    for m in ("summerset_tpu_torch.ops.rscoding",
              "summerset_tpu_torch.protocols.rspaxos",
              "summerset_tpu_torch.protocols.raft",
              "summerset_tpu_torch.protocols.craft",
              "summerset_tpu_torch.protocols.crossword",
              "summerset_tpu_torch.protocols.quorum_leases",
              "summerset_tpu_torch.protocols.bodega",
              "summerset_tpu_torch.protocols.chain_rep",
              "summerset_tpu_torch.protocols.simple_push",
              "summerset_tpu_torch.protocols.rep_nothing",
              "summerset_tpu_torch.protocols.epaxos",
              "summerset_tpu_torch.host.codeword",
              "summerset_tpu_torch.host.epaxos_exec",
              "summerset_tpu_torch.core.engine",
              "summerset_tpu_torch.bench",
              "summerset_tpu_torch.entry"):
        assert m in got["modules"]
    for m in SERVING_MODULES:
        assert m in got["modules"]


#: the serving path's modules (each also checked alone below)
SERVING_MODULES = tuple("summerset_tpu_torch." + m for m in (
    "utils.errors", "utils.logging", "utils.loops", "utils.timer",
    "utils.safetcp", "utils.wirecodec", "utils.linearize", "utils.linreg",
    "utils.qdisc", "ops.native",
    "host.statemach", "host.messages", "host.payload", "host.storage",
    "host.control", "host.transport", "host.external", "host.telemetry",
    "host.adaptive", "host.codeword", "host.tracing", "host.graftwatch",
    "host.health", "host.resharding", "host.autopilot", "utils.keyrange",
    "host.server", "manager",
    "manager.clusman", "client", "client.endpoint", "client.drivers",
    "cli", "cli.server", "cli.manager",
))

_ALONE = r"""
import importlib, json, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "summerset_tpu" or m.startswith("summerset_tpu."))
print(json.dumps(bad))
"""


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_module_alone_imports_no_jax(module):
    proc = _run(["-c", _ALONE, module])
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_RUN_CODEC_AND_WAL = r"""
import json, os, sys, tempfile
import numpy as np
from summerset_tpu_torch.host.messages import ApiReply, ApiRequest
from summerset_tpu_torch.host.statemach import Command
from summerset_tpu_torch.host.storage import LogAction, StorageHub
from summerset_tpu_torch.utils import safetcp, wirecodec
req = ApiRequest("req", req_id=1, cmd=Command("put", "k", "v"))
assert wirecodec.decode_body(wirecodec.encode_body(req)) == req
rep = ApiReply("note", seq=2, notes=[(2, "k", "v")])
assert safetcp.decode_body(safetcp.encode_frame(rep, codec=True)[8:]) == rep
frame = (3, {"msg": {"flags": np.arange(6, dtype=np.int32)}, "pp": {}})
assert wirecodec.decode_body(wirecodec.encode_body(frame))[0] == 3
hub = StorageHub(os.path.join(tempfile.mkdtemp(), "w.wal"))
hub.do_sync_action(LogAction("append", entry=("x", 1), sync=True))
native = hub.native
hub.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "summerset_tpu" or m.startswith("summerset_tpu."))
print(json.dumps({"bad": bad, "native": native}))
"""


def test_codec_and_native_wal_run_without_jax():
    proc = _run(["-c", _RUN_CODEC_AND_WAL])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "native": True}


def test_decoded_lane_views_never_reach_upload(tmp_path):
    """Frames decoded by the codec hand out read-only views into the
    received body; ``_assemble_inbox`` must build fresh arrays for the
    upload (on the CPU ``_upload`` wraps them with ``torch.from_numpy``,
    sharing memory with the tensors a step then reads).  Checked for one
    frame per peer and for superseded frames (``_peer_lanes``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import summerset_tpu_torch.host.server as tsrv
    from summerset_tpu_torch.utils import wirecodec
    from test_torch_cluster import FakeNet, build

    net = FakeNet(3)
    rep = build(tsrv, "MultiPaxos", 0, 3, 2, 16, tmp_path / "r0",
                {"pipeline": False}, net=net, device="cpu")
    try:
        out = {k: v.copy() for k, v in rep._last_out.items()}
        rng = np.random.default_rng(3)
        for v in out.values():
            v[...] = rng.integers(0, 2, v.shape).astype(v.dtype)

        def decoded(src):
            f = {"msg": {k: v[:, src] if k in rep.kernel.broadcast_lanes
                         else v[:, src, 0] for k, v in out.items()},
                 "pp": {}, "need": [], "kv_need": False, "ts": 0.0}
            _tick, back = wirecodec.decode_body(
                wirecodec.encode_body((7, f)))
            assert all(not a.flags.writeable for a in back["msg"].values())
            return back

        got = {}
        rep._upload = lambda arrays: got.update(arrays) or {}
        for frames in ({1: [decoded(1)], 2: [decoded(2)]},
                       {1: [decoded(1), decoded(1)], 2: None}):
            views = [a for fl in frames.values() for f in (fl or ())
                     for a in f["msg"].values()]
            got.clear()
            rep._assemble_inbox(out, frames)
            assert set(got) == set(out)
            for a in got.values():
                assert a.flags.writeable and a.flags.owndata
                assert not any(np.shares_memory(a, v) for v in views)
    finally:
        rep.shutdown()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "kernels" not in proc.stdout


def test_upload_ab_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: serve_upload_ab.py would run")
    proc = _run(["serve_upload_ab.py"])
    assert proc.returncode != 0
    assert "upload_ab" not in proc.stdout


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    from summerset_tpu_torch.convert import to_torch
    from summerset_tpu_torch.core import ControlInputs, Engine
    from summerset_tpu_torch.entry import entry
    from summerset_tpu_torch.host.codeword import CodewordStore
    from summerset_tpu_torch.ops.rscoding import RSCode
    from summerset_tpu_torch.core.netmodel import NetConfig, NetModel
    from summerset_tpu_torch.core.telemetry import zero_block
    from summerset_tpu_torch.host.server import ServerReplica
    from summerset_tpu_torch.ops.prng import seed_state
    from summerset_tpu_torch.protocols import make_protocol

    addr = ("127.0.0.1", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kernel = make_protocol("multipaxos", 2, 3, 32, device="cpu")
    code = RSCode(3, 2, device="cpu")
    for call in (
        lambda: Engine(kernel),
        lambda: make_protocol("multipaxos", 2, 3, 32),
        lambda: make_protocol("rspaxos", 2, 5, 32),
        lambda: make_protocol("raft", 2, 5, 32),
        lambda: make_protocol("craft", 2, 5, 32),
        lambda: make_protocol("crossword", 2, 5, 32),
        lambda: make_protocol("quorumleases", 2, 5, 32),
        lambda: make_protocol("bodega", 2, 5, 32),
        lambda: make_protocol("chainrep", 2, 5, 32),
        lambda: make_protocol("simplepush", 2, 5, 32),
        lambda: make_protocol("repnothing", 2, 5, 32),
        lambda: make_protocol("epaxos", 2, 5, 32),
        lambda: ControlInputs.all_up(2, 5),
        lambda: ControlInputs.links_all_up(2, 5),
        lambda: ControlInputs.split_links(2, 5, [0, 1]),
        lambda: ControlInputs.isolate_links(2, 5, 2),
        lambda: ControlInputs.one_way_down(2, 5, 1, 3),
        lambda: ControlInputs.skew_alive(2, 5, 4, {1: 0.5}),
        lambda: RSCode(3, 2),
        lambda: CodewordStore(2, code, total=5),
        lambda: entry(),
        lambda: to_torch({"x": [1, 2]}),
        lambda: zero_block(2, 3),
        lambda: seed_state(5, (2, 3)),
        lambda: NetModel(NetConfig(), 2, 3, frozenset()),
        lambda: ServerReplica("MultiPaxos", addr, addr, addr),
        lambda: ServerReplica("RSPaxos", addr, addr, addr),
        lambda: ServerReplica("CRaft", addr, addr, addr),
        lambda: ServerReplica("Crossword", addr, addr, addr),
        lambda: ServerReplica("QuorumLeases", addr, addr, addr),
        lambda: ServerReplica("Bodega", addr, addr, addr),
        lambda: ServerReplica("EPaxos", addr, addr, addr),
        lambda: ServerReplica("ChainRep", addr, addr, addr),
        lambda: ServerReplica("SimplePush", addr, addr, addr),
        lambda: ServerReplica("RepNothing", addr, addr, addr),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # with the CPU asked for explicitly, everything builds there
    eng = Engine(kernel, device="cpu")
    assert eng.init()[0]["commit_bar"].device.type == "cpu"
    assert ControlInputs.all_up(2, 3, device="cpu").alive.device.type == \
        "cpu"


def test_helpers_place_tensors_beside_the_state(monkeypatch):
    """The server attaches the telemetry block after ``init_state`` as
    the JAX server does, with no ``device``: the block must land on the
    state's device (``meta`` stands in for the card here), and the
    other helpers called without ``device`` follow the device rule
    (the card, or an error without one) instead of the CPU."""
    from summerset_tpu_torch.core import telemetry
    from summerset_tpu_torch.core.netmodel import NetConfig, NetModel
    from summerset_tpu_torch.ops.prng import seed_state

    for dev in ("meta", "cpu"):
        state = {"commit_bar": torch.zeros((2, 3), dtype=torch.int32,
                                           device=dev)}
        telemetry.attach(state, 2, 3)
        assert state[telemetry.TELEM_KEY].device.type == dev
        assert tuple(state[telemetry.TELEM_KEY].shape) == (2, 3,
                                                           telemetry.K)
    assert telemetry.zero_block(2, 3, device="cpu").device.type == "cpu"
    assert seed_state(5, (2, 3), device="cpu").device.type == "cpu"
    # without a device they follow the device rule: no card, no tensor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: telemetry.zero_block(2, 3),
        lambda: telemetry.attach({}, 2, 3),
        lambda: seed_state(5, (2, 3)),
        lambda: NetModel(NetConfig(), 2, 3, frozenset()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
