"""Vectorized Chain Replication (partial, no fault tolerance), counterpart
of ``summerset_tpu/protocols/chain_rep.py``: each node runs a go-back-N
range stream to its successor (position ``rid + 1``), the tail's durable
frontier is the commit point, and acks ripple back up the chain as a
cumulative ``commit_bar``.
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
    arange32,
    client_intake,
    first_true,
    flag_bits,
    range_cover,
    take_lane,
    take_src,
)

PROP = 1   # Propagate range down-chain
ACK = 2    # cumulative ack up-chain (carries committed frontier)


@dataclasses.dataclass
class ReplicaConfigChainRep:
    """The same fields and defaults as the JAX ``ReplicaConfigChainRep``."""

    max_proposals_per_tick: int = 16
    chunk_size: int = 64
    retry_interval: int = 8
    dur_lag: int = 0
    exec_follows_commit: bool = True


@register_protocol("ChainRep")
class ChainRepKernel(ProtocolKernel):
    broadcast_lanes = frozenset({"bw_abs", "bw_val"})

    # durable record: a chain node's received/appended prefix
    DURABLE_SCALARS = ("prop_bar", "dur_bar")
    DURABLE_WINDOWS = ("win_abs", "win_val")

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigChainRep | None = None,
        device=None,
    ):
        super().__init__(num_groups, population, window, device)
        self.config = config or ReplicaConfigChainRep()
        if self.config.max_proposals_per_tick > window // 2:
            raise ValueError("max_proposals_per_tick must be <= window/2")
        self._chunk = min(self.config.chunk_size, window)
        self._build_consts()

    def _build_consts(self) -> None:
        G, Rr, R, dev = self.G, self.rows, self.R, self.device
        self._rid = self.row_ids()[None, :].expand(G, Rr)
        dst = arange32(R, dev)[None, None, :]
        rid = self._rid[..., None]
        # [G, rows, R_dst] one-hot of each node's successor / predecessor
        self._succ = (dst == rid + 1).expand(G, Rr, R)
        self._pred = (dst == rid - 1).expand(G, Rr, R)

    def init_state(self, seed: int = 0):
        G, R, W = self.G, self.R, self.W
        zeros = self.zeros
        return {
            "prop_bar": zeros(G, R),   # contiguous received/appended frontier
            "dur_bar": zeros(G, R),
            "commit_bar": zeros(G, R),
            "exec_bar": zeros(G, R),
            "next_idx": zeros(G, R),   # send cursor toward successor
            "match_f": zeros(G, R),    # successor's acked frontier
            "retry_cnt": self.full((G, R), self.config.retry_interval),
            "win_abs": self.full((G, R, W), NO_SLOT),
            "win_val": zeros(G, R, W),
        }

    def zero_outbox(self):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        pair = lambda: self.zeros(G, Rr, R)  # noqa: E731
        return {
            "flags": pair(),
            "pp_lo": pair(), "pp_hi": pair(),
            "ak_f": pair(), "ak_cbar": pair(),
            "bw_abs": self.zeros(G, Rr, W),
            "bw_val": self.zeros(G, Rr, W),
        }

    PHASES: Tuple[Tuple[str, str], ...] = (
        ("ingest_prop", "_ingest_prop"),
        ("ingest_ack", "_ingest_ack"),
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
        c.rid = self._rid
        c.is_head = c.rid == 0
        c.is_tail = c.rid == self.R - 1
        self._run_phases(s, c)
        fx = StepEffects(
            commit_bar=s["commit_bar"],
            exec_bar=s["exec_bar"],
            extra={
                "n_accepted": c.n_new,
                "is_leader": c.is_head,
                "snap_bar": s["exec_bar"],
            },
        )
        return s, c.out, fx

    # ---- PROP ingest (from predecessor): contiguous range accept
    def _ingest_prop(self, s, c):
        p_valid = (c.flags & PROP) != 0
        p_src = first_true(p_valid, 2)
        p_ok = p_valid.any(dim=2) & ~c.is_head & (p_src == c.rid - 1)
        p_lo = take_src(c.inbox["pp_lo"], p_src)
        p_hi = take_src(c.inbox["pp_hi"], p_src)
        acc = p_ok & (p_lo <= s["prop_bar"]) & (p_hi > s["prop_bar"])
        m_acc, abs_acc = range_cover(p_lo, p_hi, self.W)
        m_acc = m_acc & acc[..., None]
        lane_val = take_lane(c.inbox["bw_val"], p_src)
        s["win_abs"] = torch.where(m_acc, abs_acc, s["win_abs"])
        s["win_val"] = torch.where(m_acc, lane_val, s["win_val"])
        s["prop_bar"] = torch.where(
            acc, torch.maximum(s["prop_bar"], p_hi), s["prop_bar"]
        )

    # ---- ACK ingest (from successor): acked frontier + commit ripple
    def _ingest_ack(self, s, c):
        cfg = self.config
        a_valid = (c.flags & ACK) != 0
        a_src = first_true(a_valid, 2)
        a_ok = a_valid.any(dim=2) & ~c.is_tail & (a_src == c.rid + 1)
        a_f = take_src(c.inbox["ak_f"], a_src)
        a_cbar = take_src(c.inbox["ak_cbar"], a_src)
        prog = a_ok & (a_f > s["match_f"])
        s["match_f"] = torch.where(
            a_ok, torch.maximum(s["match_f"], a_f), s["match_f"]
        )
        s["retry_cnt"] = torch.where(prog, cfg.retry_interval,
                                     s["retry_cnt"])
        c.up_commit = torch.where(a_ok, a_cbar, 0)

    # ---- head proposals
    def _intake(self, s, c):
        n_new, m_new, abs_new, new_vals = client_intake(
            s, c.inputs, c.is_head, self.config.max_proposals_per_tick,
            self.W, frontier="prop_bar",
        )
        s["win_abs"] = torch.where(m_new, abs_new, s["win_abs"])
        s["win_val"] = torch.where(m_new, new_vals, s["win_val"])
        s["prop_bar"] = s["prop_bar"] + n_new
        c.n_new = n_new

    # ---- durability + commit
    def _advance_bars(self, s, c):
        cfg = self.config
        s["dur_bar"] = advance_durability(s, cfg.dur_lag, frontier="prop_bar")
        # tail: everything durable at the tail is committed; others: commit
        # ripples up via ACKs
        s["commit_bar"] = torch.where(
            c.is_tail,
            s["dur_bar"],
            torch.maximum(
                s["commit_bar"], torch.minimum(c.up_commit, s["prop_bar"])
            ),
        )
        s["exec_bar"] = advance_exec(s, c.inputs, cfg.exec_follows_commit)

    # ---- outbox
    def _build_outbox(self, s, c):
        cfg = self.config
        out = {}
        not_tail = ~c.is_tail
        succ = self._succ & not_tail[..., None]

        stale = not_tail & (s["next_idx"] > s["match_f"])
        s["retry_cnt"] = torch.where(
            stale, s["retry_cnt"] - 1, cfg.retry_interval
        )
        rewind = stale & (s["retry_cnt"] <= 0)
        s["next_idx"] = torch.where(rewind, s["match_f"], s["next_idx"])
        s["retry_cnt"] = torch.where(rewind, cfg.retry_interval,
                                     s["retry_cnt"])

        snd_lo = s["next_idx"]
        snd_hi = torch.minimum(s["dur_bar"], snd_lo + self._chunk)
        do_prop = (snd_hi > snd_lo) & not_tail
        oflags = flag_bits(do_prop[..., None] & succ, PROP)
        out["pp_lo"] = torch.where(succ, snd_lo[..., None], 0)
        out["pp_hi"] = torch.where(succ, snd_hi[..., None], 0)
        s["next_idx"] = torch.where(do_prop, snd_hi, s["next_idx"])

        # ACK to predecessor every tick: durable frontier + commit bar
        pred = self._pred & ~c.is_head[..., None]
        oflags = oflags | flag_bits(pred, ACK)
        out["ak_f"] = torch.where(pred, s["dur_bar"][..., None], 0)
        out["ak_cbar"] = torch.where(pred, s["commit_bar"][..., None], 0)

        out["bw_abs"] = s["win_abs"]
        out["bw_val"] = s["win_val"]
        out["flags"] = oflags
        return out
