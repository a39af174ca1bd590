"""The flagship step of the port, counterpart of ``__graft_entry__.entry``:
one lockstep tick of batched MultiPaxos on 1024 groups x 5 replicas
(window 64, 16 proposals per group per tick)."""

from __future__ import annotations

import torch

from .core import Engine
from .core.engine import _tick
from .device import resolve_device
from .protocols import make_protocol
from .protocols.multipaxos import ReplicaConfigMultiPaxos


def entry(device=None):
    """``(fn, example_args)``: ``fn(state, netstate, inputs)`` runs one
    tick and returns ``(state, netstate, effects)``."""
    dev = resolve_device(device)
    cfg = ReplicaConfigMultiPaxos(max_proposals_per_tick=16)
    eng = Engine(make_protocol("multipaxos", 1024, 5, 64, cfg, device=dev),
                 device=dev)
    state, ns = eng.init()
    G = eng.kernel.G
    inputs = {
        "n_proposals": torch.full((G,), 16, dtype=torch.int32,
                                  device=eng.device),
        "value_base": torch.zeros((G,), dtype=torch.int32, device=eng.device),
    }

    def fn(state, ns, inputs):
        return _tick(eng.kernel, eng.net, eng._boot, state, ns, inputs)

    return fn, (state, ns, inputs)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run sharded ticks over an ``n_devices`` ``(group, replica)`` mesh,
    counterpart of ``__graft_entry__.dryrun_multichip``: replica_shards 2
    where ``n_devices`` is even, tiny shapes (4 groups per group shard, 2
    replicas per replica shard), 4 ticks of proposals.  ``devices``
    defaults to the visible cards (too few raise); a list may repeat one
    device (``["cpu"] * 8`` on a CPU, ``["cuda:0"] * 4`` on one card).
    A split replica axis must move lanes between shards, and the run must
    commit.  Returns the mesh stamp with the commit bar's max and the
    bytes moved."""
    from .core import sharding as shardlib

    replica_shards = 2 if n_devices % 2 == 0 else 1
    group_shards = n_devices // replica_shards
    mesh = shardlib.mesh_for(group_shards, replica_shards, devices,
                             repeat=devices is not None)
    dev = mesh.devices[0, 0]
    G = group_shards * 4
    R = replica_shards * 2
    cfg = ReplicaConfigMultiPaxos(max_proposals_per_tick=4)
    eng = Engine(make_protocol("multipaxos", G, R, 16, cfg, device=dev),
                 device=dev, mesh=mesh)
    state, ns = eng.init()
    inputs = {
        "n_proposals": torch.full((G,), 4, dtype=torch.int32, device=dev),
        "value_base": torch.zeros((G,), dtype=torch.int32, device=dev),
    }
    for _ in range(4):
        state, ns, fx = eng.tick(state, ns, inputs)
    committed = int(fx.commit_bar.max())
    if committed <= 0:
        raise AssertionError("sharded engine made no commits")
    if replica_shards > 1 and eng.xfer["bytes"] == 0:
        raise AssertionError("no lane crossed between replica shards: the "
                             "replica axis is not actually split")
    print(f"dryrun_multichip OK: mesh {group_shards}x{replica_shards} "
          f"(group x replica), {G} groups x {R} replicas, commit_bar max = "
          f"{committed}, {eng.xfer['bytes']} bytes between shards")
    return dict(shardlib.mesh_stamp(group_shards, replica_shards, G),
                committed=committed, xfer_bytes=eng.xfer["bytes"])
