"""Vectorized RepNothing: no replication, the baseline protocol,
counterpart of ``summerset_tpu/protocols/rep_nothing.py``: the group's
proposal stream lands on replica 0, which logs it locally, commits at its
durable frontier and executes.  No peer messages at all.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Tuple

import torch

from ..core.protocol import ProtocolKernel, StepEffects
from . import register_protocol
from .common import (
    NO_SLOT,
    advance_durability,
    advance_exec,
    client_intake,
)


@dataclasses.dataclass
class ReplicaConfigRepNothing:
    """The same fields and defaults as the JAX
    ``ReplicaConfigRepNothing``."""

    max_proposals_per_tick: int = 16
    dur_lag: int = 0                  # WAL ack lag in slots/tick (0=instant)
    exec_follows_commit: bool = True


@register_protocol("RepNothing")
class RepNothingKernel(ProtocolKernel):
    # durable record: the local log is the only copy
    DURABLE_SCALARS = ("next_slot",)
    DURABLE_WINDOWS = ("win_abs", "win_val")

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigRepNothing | None = None,
        device=None,
    ):
        super().__init__(num_groups, population, window, device)
        self.config = config or ReplicaConfigRepNothing()
        if self.config.max_proposals_per_tick > window:
            raise ValueError("max_proposals_per_tick must be <= window")
        self._build_consts()

    def _build_consts(self) -> None:
        self._serving = self.row_ids()[None, :].expand(
            self.G, self.rows) == 0

    def init_state(self, seed: int = 0):
        G, R, W = self.G, self.R, self.W
        zeros = self.zeros
        return {
            "next_slot": zeros(G, R),
            "dur_bar": zeros(G, R),
            "commit_bar": zeros(G, R),
            "exec_bar": zeros(G, R),
            "win_abs": self.full((G, R, W), NO_SLOT),
            "win_val": zeros(G, R, W),
        }

    def zero_outbox(self):
        return {"flags": self.zeros(self.G, self.rows, self.R)}

    PHASES: Tuple[Tuple[str, str], ...] = (
        ("intake", "_intake"),
        ("advance_bars", "_advance_bars"),
        ("build_outbox", "_phase_build_outbox"),
        ("telemetry", "_phase_telemetry"),
    )

    def step(self, state, inbox, inputs) -> Tuple[Any, Any, StepEffects]:
        s = dict(state)
        c = SimpleNamespace(
            inbox=inbox, inputs=inputs, flags=inbox["flags"], old=state
        )
        c.serving = self._serving
        self._run_phases(s, c)
        fx = StepEffects(
            commit_bar=s["commit_bar"],
            exec_bar=s["exec_bar"],
            extra={
                "n_accepted": c.n_new,
                "is_leader": c.serving,
                "snap_bar": s["exec_bar"],
            },
        )
        return s, c.out, fx

    def _intake(self, s, c):
        n_new, m_new, abs_new, new_vals = client_intake(
            s, c.inputs, c.serving, self.config.max_proposals_per_tick,
            self.W,
        )
        s["win_abs"] = torch.where(m_new, abs_new, s["win_abs"])
        s["win_val"] = torch.where(m_new, new_vals, s["win_val"])
        s["next_slot"] = s["next_slot"] + n_new
        c.n_new = n_new

    def _advance_bars(self, s, c):
        cfg = self.config
        s["dur_bar"] = advance_durability(s, cfg.dur_lag)
        s["commit_bar"] = s["dur_bar"]
        s["exec_bar"] = advance_exec(s, c.inputs, cfg.exec_follows_commit)

    def _build_outbox(self, s, c):
        return self.zero_outbox()
