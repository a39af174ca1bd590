"""The port's bench entry point (``summerset_tpu_torch/bench.py``) against
the JAX engine, on the CPU.

- its committed slots per window at G=8, W=32, P=8 over 16-tick windows
  equal the JAX ``Engine.run_synthetic``'s at the same kernel config
  (exact: integer counts), for both tally transports;
- ``python -m summerset_tpu_torch.bench --device cpu`` prints one JSON
  line with ``bench.py``'s keys and ``ok`` true;
- a card requested without one raises (no fallback); ``--mesh`` runs on
  a mesh of repeated CPU handles with ``--device cpu`` (its committed
  slots equal the mesh-less run's) and refuses only a geometry it cannot
  split.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from summerset_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(groups=8, population=5, window=32, proposals_per_tick=8,
             ticks=16, runs=2)
ENV = {"BENCH_GROUPS": "8", "BENCH_POPULATION": "5", "BENCH_WINDOW": "32",
       "BENCH_PROPS": "8", "BENCH_TICKS": "16", "BENCH_RUNS": "2"}


def _jax_windows(tally):
    """The JAX engine at the bench's config: a warm-up window, then the
    timed windows' committed-slot counts."""
    import numpy as np

    from summerset_tpu.core import Engine
    from summerset_tpu.protocols import make_protocol
    from summerset_tpu.protocols.multipaxos import ReplicaConfigMultiPaxos

    P, T = SHAPE["proposals_per_tick"], SHAPE["ticks"]
    cfg = ReplicaConfigMultiPaxos(
        max_proposals_per_tick=P, chunk_size=2 * P,
        exec_follows_commit=False, tally=tally,
    )
    eng = Engine(make_protocol("multipaxos", SHAPE["groups"],
                               SHAPE["population"], SHAPE["window"], cfg))
    state, ns = eng.init()
    state, ns = eng.run_synthetic(state, ns, T, P)
    out = []
    for _ in range(SHAPE["runs"]):
        start = int(np.asarray(state["commit_bar"]).max(axis=1).sum())
        state, ns = eng.run_synthetic(state, ns, T, P)
        end = int(np.asarray(state["commit_bar"]).max(axis=1).sum())
        out.append(end - start)
    return out


@pytest.mark.parametrize("tally", ["pairwise", "collective"])
def test_committed_slots_equal_jax(tally):
    port = [w["slots"] for w in bench.measure(SHAPE, tally, device="cpu")]
    assert all(n > 0 for n in port), port
    assert port == _jax_windows(tally)


def test_cli_prints_one_json_line_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, **ENV)
    proc = subprocess.run(
        [sys.executable, "-m", "summerset_tpu_torch.bench", "--device",
         "cpu", "--tally", "collective"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    for k in ("metric", "value", "unit", "vs_baseline", "backend", "tally",
              "ok"):
        assert k in doc
    assert doc["ok"] is True and doc["value"] > 0
    assert doc["backend"] == "cpu" and doc["card"] is None
    assert doc["tally"] == "collective" and doc["unit"] == "slots/sec"
    assert doc["shape"] == SHAPE
    assert doc["vs_baseline"] == round(doc["value"] / 10_000_000.0, 4)


def test_card_requested_without_one_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main(["--device", "cuda"])


def test_mesh_is_refused(monkeypatch, capsys):
    """The mesh is accepted: ``--mesh 2x1`` on the CPU prints the bench's
    line with the mesh stamp and the same committed slots per window as
    the mesh-less run; only a geometry the mesh cannot split (R=5 rows
    over 2 replica shards) is refused, naming the axis."""
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--mesh", "2x1", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["ok"] is True and doc["backend"] == "cpu"
    assert doc["mesh"]["mesh"] == "2x1"
    assert doc["mesh"]["groups_per_device"] == SHAPE["groups"] // 2
    assert doc["mesh"]["device_list"] == ["cpu", "cpu"]
    assert doc["xfer_bytes_per_tick"] == 0
    assert [w["slots"] for w in doc["windows"]] == [
        w["slots"] for w in bench.measure(SHAPE, "pairwise", device="cpu")]
    monkeypatch.setenv("BENCH_MESH", "4x2")
    with pytest.raises(ValueError, match="replica_shards=2"):
        bench.main(["--device", "cpu"])
