"""Headline benchmark of the port: batched MultiPaxos commit throughput on
one NVIDIA card, counterpart of the repo root's ``bench.py``.

Run ``python -m summerset_tpu_torch.bench [--tally pairwise|collective]
[--device cpu]``.  It prints ONE JSON line with ``bench.py``'s keys
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``backend``, ``tally``,
``ok``) plus ``card`` (``nvidia-smi``'s name and power limit, null on the
CPU) and ``shape``.

The workload is ``bench.py``'s: every tick each group is offered ``P``
new commands and the synthetic applier saturates (``exec_floor`` 2^30),
with ``exec_follows_commit=False`` and ``chunk_size = 2P``, through the
port's ``Engine.run_synthetic``.  One warm-up window, then the best of
``RUNS`` timed windows, each ending in a device sync; a window's count
is the growth of ``commit_bar.max(axis=1).sum()``, committed slots over
all groups.  Shapes come from the environment as in ``bench.py``:
``BENCH_GROUPS`` (4096), ``BENCH_POPULATION`` (5), ``BENCH_WINDOW`` (128),
``BENCH_PROPS`` (32), ``BENCH_TICKS`` (2048), ``BENCH_RUNS`` (3),
``BENCH_TALLY``.

``vs_baseline`` is the ratio to the target figure in ``BASELINE.json``
(10M committed slots/s), kept for format parity; it is not a comparison
with any TPU reading.  Without a card the run raises unless ``--device
cpu`` is given (no fallback); the CPU line says ``"backend": "cpu"``.

``--mesh GxR`` (or ``BENCH_MESH``) shards the groups (and the replica
rows) over a ``(group, replica)`` mesh (``core/sharding.py``) of the
visible cards, or of the devices ``--mesh-devices`` lists (which may
repeat one card); with ``--device cpu`` the mesh is made of repeated CPU
handles.  A mesh the visible cards cannot hold fails; there is no CPU
fallback.  The line then carries ``mesh_stamp``'s block under ``mesh``
and the bytes that crossed between shards per tick.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Optional

import torch

from .core import Engine
from .core import sharding as shardlib
from .device import resolve_device
from .protocols import make_protocol
from .protocols.multipaxos import ReplicaConfigMultiPaxos

BASELINE = 10_000_000.0


def shape_from_env() -> Dict[str, int]:
    """The bench shape, env-overridable (``bench.py:44-52``)."""
    env = os.environ.get
    return {
        "groups": int(env("BENCH_GROUPS", "4096")),
        "population": int(env("BENCH_POPULATION", "5")),
        "window": int(env("BENCH_WINDOW", "128")),
        "proposals_per_tick": int(env("BENCH_PROPS", "32")),
        "ticks": int(env("BENCH_TICKS", "2048")),
        "runs": int(env("BENCH_RUNS", "3")),
    }


def make_engine(shape: Dict[str, int], tally: str, device,
                mesh=None) -> Engine:
    """The bench's engine: ``bench.py:193-198``'s kernel config."""
    P = shape["proposals_per_tick"]
    cfg = ReplicaConfigMultiPaxos(
        max_proposals_per_tick=P, chunk_size=2 * P,
        exec_follows_commit=False, tally=tally,
    )
    kernel = make_protocol("multipaxos", shape["groups"],
                           shape["population"], shape["window"], cfg,
                           device=device)
    return Engine(kernel, device=device, mesh=mesh)


def committed(state) -> int:
    """Committed slots over all groups: the highest replica commit bar of
    each group, summed."""
    return int(state["commit_bar"].amax(dim=1).sum())


def bench_mesh(spec: str, device, devices=None):
    """The bench's mesh for ``spec`` (``"GxR"``): over ``devices`` if
    given (repeats allowed), repeated CPU handles on the CPU, else the
    visible cards (too few fail)."""
    gs, rs = shardlib.parse_mesh(spec)
    if devices is None and torch.device(device).type == "cpu":
        devices = ["cpu"] * (gs * rs)
    return shardlib.mesh_for(gs, rs, devices, repeat=devices is not None)


def measure(shape: Dict[str, int], tally: str = "pairwise",
            device=None, mesh=None) -> List[Dict[str, float]]:
    """One warm-up window, then ``runs`` timed windows of ``ticks`` ticks;
    returns each timed window's committed slots, seconds and the bytes
    moved between mesh shards."""
    dev = resolve_device(device)
    eng = make_engine(shape, tally, dev, mesh)
    T, P = shape["ticks"], shape["proposals_per_tick"]

    devs = ({str(d) for d in mesh.devices.flat} if mesh is not None
            else {str(dev)})

    def sync():
        if dev.type == "cuda":
            for d in devs:
                torch.cuda.synchronize(d)

    with torch.inference_mode():
        state, ns = eng.init()
        state, ns = eng.run_synthetic(state, ns, T, P)
        sync()
        out = []
        for _ in range(shape["runs"]):
            start = committed(state)
            moved = eng.xfer["bytes"]
            t0 = time.perf_counter()
            state, ns = eng.run_synthetic(state, ns, T, P)
            sync()
            dt = time.perf_counter() - t0
            out.append({"slots": committed(state) - start, "secs": dt,
                        "xfer_bytes": eng.xfer["bytes"] - moved})
    return out


def card_stamp() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tally", default=os.environ.get("BENCH_TALLY",
                                                      "pairwise"),
                    choices=("pairwise", "collective"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    ap.add_argument("--mesh", default=os.environ.get("BENCH_MESH", ""),
                    help="GxR (group_shards x replica_shards) device mesh; "
                         "empty = one device")
    ap.add_argument("--mesh-devices", default=None,
                    help="comma-separated mesh devices (may repeat one, "
                         "e.g. cuda:0,cuda:0); default the visible cards")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shape = shape_from_env()
    mesh = None
    if args.mesh:
        mesh = bench_mesh(args.mesh, dev,
                          shardlib.mesh_devices(args.mesh_devices))
    wins = measure(shape, args.tally, dev, mesh)
    rate = max(w["slots"] / w["secs"] for w in wins)
    backend = dev.type
    doc = {
        "metric": (
            f"committed slots/sec, MultiPaxos {shape['population']}-replica"
            f" x {shape['groups']} groups, "
            + (f"mesh {mesh.spec} ({backend})" if mesh is not None
               else f"1 card ({backend})")
        ),
        "value": round(rate, 1),
        "unit": "slots/sec",
        "vs_baseline": round(rate / BASELINE, 4),
        "backend": backend,
        "tally": args.tally,
        "ok": rate > 0,
        "card": card_stamp() if backend == "cuda" else None,
        "shape": shape,
        "windows": [{"slots": w["slots"], "secs": round(w["secs"], 6)}
                    for w in wins],
    }
    if mesh is not None:
        gs, rs = mesh.shape["group"], mesh.shape["replica"]
        doc["mesh"] = dict(shardlib.mesh_stamp(gs, rs, shape["groups"]),
                           device_list=[str(d) for d in mesh.devices.flat])
        doc["xfer_bytes_per_tick"] = wins[-1]["xfer_bytes"] / shape["ticks"]
    print(json.dumps(doc), flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
