"""Quorum-tally plane, counterpart of ``summerset_tpu/core/quorum.py``.

Two modes, selected by the kernel config's ``tally`` field: ``pairwise``
keeps the per-source tally records as ``[G, R, R]`` pair lanes through the
delay line; ``collective`` shrinks them to ``[G, R_src]`` broadcast lanes
while the ``flags`` pair-field keeps per-link masking, so both modes give
byte-identical state.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

from .protocol import phase_scope

PHASE_TALLY = "quorum_tally"

TALLY_MODES = ("pairwise", "collective")

_INF = 1 << 30


def check_tally(mode: str) -> str:
    if mode not in TALLY_MODES:
        raise ValueError(
            f"unknown tally mode {mode!r}; pick one of {TALLY_MODES}"
        )
    return mode


def tally_scope():
    return phase_scope(PHASE_TALLY)


def pair_views(inbox, names: Iterable[str], collective: bool
               ) -> Dict[str, Any]:
    """Receiver-oriented views of the tally lanes: pairwise lanes as
    delivered ``[G, R_dst, R_src]``, collective ``[G, R_src]`` records as
    ``[G, 1, R_src]``."""
    if not collective:
        return {k: inbox[k] for k in names}
    return {k: inbox[k][:, None, :] for k in names}


def source_lane(gate: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Collective-mode outbox record: ``value`` where ``gate``, else 0."""
    return torch.where(gate, value, 0)


def quorum_frontier(frontiers: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest cumulative frontier along the last (replica) axis."""
    r = frontiers.shape[-1]
    return torch.sort(frontiers, dim=-1).values[..., r - k]


def coverage_frontier(cover, abs_w, need, slot_known, in_rng):
    """First absolute slot whose coverage fails, ``[G, R]`` (INF when the
    whole range passes); see the JAX counterpart for the argument shapes."""
    cnt = (cover[..., :, None] > abs_w[..., None, :]).sum(
        dim=2, dtype=torch.int32
    )
    fail = in_rng & ~((cnt >= need) & slot_known)
    return torch.amin(torch.where(fail, abs_w, _INF), dim=2)
