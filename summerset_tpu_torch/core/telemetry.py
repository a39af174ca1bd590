"""In-kernel metric lanes: the ``[G, R, K]`` int32 telemetry block, counterpart
of ``summerset_tpu/core/telemetry.py`` (same lane order, same fold rules).

The block is replaced, never updated in place: the engine's freeze reads
the pre-tick state after the step, so the old block must survive.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device

COUNTER_LANES = (
    "commits",
    "proposals",
    "elections",
    "ballots_adopted",
    "heartbeats",
    "grants",
    "net_drops",
    "net_delay_ticks",
)
MAXGAUGE_LANES = (
    "win_occupancy_hw",
)
LANES = COUNTER_LANES + MAXGAUGE_LANES
K = len(LANES)
LANE_IDX: Dict[str, int] = {n: i for i, n in enumerate(LANES)}
_MAX_SET = frozenset(MAXGAUGE_LANES)

TELEM_KEY = "telem"


def zero_block(num_groups: int, population: int, device=None):
    """Fresh ``[G, R, K]`` lane block (every lane zero) on ``device``
    (resolved by the port's device rule: ``None`` is the card)."""
    return torch.zeros((num_groups, population, K), dtype=torch.int32,
                       device=resolve_device(device))


def attach(state: Dict[str, Any], num_groups: int, population: int,
           device=None):
    """Add the lane block to a state dict (idempotent).  With no
    ``device`` the block goes where the state's tensors live, so it
    never lands on the CPU beside a state on the card."""
    if TELEM_KEY not in state:
        if device is None:
            dev = next((v.device for v in state.values()
                        if isinstance(v, torch.Tensor)), None)
            device = dev if dev is not None else resolve_device(None)
        state[TELEM_KEY] = zero_block(num_groups, population, device)
    return state


def accumulate(telem: torch.Tensor, contrib: Dict[str, Any]) -> torch.Tensor:
    """Fold per-tick ``[G, R]`` contributions into the block: counter lanes
    add, high-water lanes take the running max.  Unknown lane names are a
    bug in the contributing kernel."""
    for name in contrib:
        if name not in LANE_IDX:
            raise KeyError(name)
    G, R, _ = telem.shape
    zero = torch.zeros((G, R), dtype=torch.int32, device=telem.device)

    def col(name):
        v = contrib.get(name)
        if v is None:
            return zero
        return v.to(torch.int32)

    nc = len(COUNTER_LANES)
    cnt, hw = telem[:, :, :nc], telem[:, :, nc:]
    if any(n in contrib for n in COUNTER_LANES):
        cnt = cnt + torch.stack([col(n) for n in COUNTER_LANES], dim=-1)
    if any(n in contrib for n in MAXGAUGE_LANES):
        hw = torch.maximum(
            hw, torch.stack([col(n) for n in MAXGAUGE_LANES], dim=-1)
        )
    return torch.cat([cnt, hw], dim=-1)


def bump(telem: torch.Tensor, name: str, v: torch.Tensor) -> torch.Tensor:
    """Fold one lane (same semantics as :func:`accumulate`)."""
    v = v.to(torch.int32)
    i = LANE_IDX[name]
    lane = telem[:, :, i]
    lane = torch.maximum(lane, v) if name in _MAX_SET else lane + v
    return torch.cat(
        [telem[:, :, :i], lane.unsqueeze(-1), telem[:, :, i + 1:]], dim=-1
    )
