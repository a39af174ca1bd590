"""The port stands alone: importing ``summerset_tpu_torch`` (every module)
and ``chip_smoke`` loads neither ``jax`` nor the JAX package, and no entry
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
import chip_smoke
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
              "summerset_tpu_torch.host.codeword",
              "summerset_tpu_torch.core.engine",
              "summerset_tpu_torch.entry"):
        assert m in got["modules"]


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "kernels" not in proc.stdout


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    from summerset_tpu_torch.convert import to_torch
    from summerset_tpu_torch.core import Engine
    from summerset_tpu_torch.entry import entry
    from summerset_tpu_torch.host.codeword import CodewordStore
    from summerset_tpu_torch.ops.rscoding import RSCode
    from summerset_tpu_torch.protocols import make_protocol

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kernel = make_protocol("multipaxos", 2, 3, 32, device="cpu")
    code = RSCode(3, 2, device="cpu")
    for call in (
        lambda: Engine(kernel),
        lambda: make_protocol("multipaxos", 2, 3, 32),
        lambda: make_protocol("rspaxos", 2, 5, 32),
        lambda: RSCode(3, 2),
        lambda: CodewordStore(2, code, total=5),
        lambda: entry(),
        lambda: to_torch({"x": [1, 2]}),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # with the CPU asked for explicitly, everything builds there
    eng = Engine(kernel, device="cpu")
    assert eng.init()[0]["commit_bar"].device.type == "cpu"
