"""The port stands alone: importing ``summerset_tpu_torch`` (every module),
``chip_smoke`` and ``serve_upload_ab`` loads neither ``jax`` nor the JAX package, and no entry
point of the port falls back to the CPU by itself.

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
    "utils.safetcp", "utils.linearize", "utils.linreg", "utils.qdisc",
    "host.statemach", "host.messages", "host.payload", "host.storage",
    "host.control", "host.transport", "host.external", "host.telemetry",
    "host.adaptive", "host.codeword", "host.server", "manager",
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
