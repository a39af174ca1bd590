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
