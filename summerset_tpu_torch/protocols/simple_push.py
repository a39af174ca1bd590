"""Vectorized SimplePush: push-to-peers best-effort replication,
counterpart of ``summerset_tpu/protocols/simple_push.py``: the serving
node (replica 0) runs a go-back-N range stream with cumulative acks to
each of its ``rep_degree`` pushed peers (replicas ``1..degree``) and
commits up to the minimum of its own durable frontier and their acked
frontiers.  No election, no ballots, not fault tolerant.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Tuple

import torch

from ..core.protocol import ProtocolKernel, StepEffects
from . import register_protocol
from .common import (
    I32_MAX,
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

PUSH = 1
PUSH_REPLY = 2


@dataclasses.dataclass
class ReplicaConfigSimplePush:
    """The same fields and defaults as the JAX ``ReplicaConfigSimplePush``
    (``rep_degree``: how many peers each batch is pushed to)."""

    max_proposals_per_tick: int = 16
    chunk_size: int = 64
    rep_degree: int = -1              # peers pushed to; -1 = all peers
    retry_interval: int = 8
    dur_lag: int = 0
    exec_follows_commit: bool = True


@register_protocol("SimplePush")
class SimplePushKernel(ProtocolKernel):
    broadcast_lanes = frozenset({"bw_abs", "bw_val"})

    # durable record: the serving node's appended log and a peer's
    # contiguous received frontier
    DURABLE_SCALARS = ("next_slot", "dur_bar")
    DURABLE_WINDOWS = ("win_abs", "win_val")

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigSimplePush | None = None,
        device=None,
    ):
        super().__init__(num_groups, population, window, device)
        self.config = config or ReplicaConfigSimplePush()
        if self.config.max_proposals_per_tick > window // 2:
            raise ValueError("max_proposals_per_tick must be <= window/2")
        self._chunk = min(self.config.chunk_size, window)
        deg = self.config.rep_degree
        self._degree = population - 1 if deg < 0 else min(deg, population - 1)
        self._build_consts()

    def _build_consts(self) -> None:
        G, Rr, R, dev = self.G, self.rows, self.R, self.device
        self._rid = self.row_ids()[None, :].expand(G, Rr)
        # pushed peer set: replicas 1..degree (fixed, as in the reference)
        self._pushed = (self._rid >= 1) & (self._rid <= self._degree)
        # [G, rows, R_dst]: destinations that are pushed peers / replica 0
        peer = arange32(R, dev)
        self._dst_pushed = ((peer >= 1) & (peer <= self._degree))[
            None, None, :].expand(G, Rr, R)
        self._to_serving = (peer == 0)[None, None, :]

    def init_state(self, seed: int = 0):
        G, R, W = self.G, self.R, self.W
        zeros = self.zeros
        return {
            "next_slot": zeros(G, R),      # serving: append frontier;
            "dur_bar": zeros(G, R),        # peers: contiguous recv frontier
            "commit_bar": zeros(G, R),
            "exec_bar": zeros(G, R),
            "next_idx": zeros(G, R, R),
            "match_f": zeros(G, R, R),
            "retry_cnt": self.full((G, R, R), self.config.retry_interval),
            "win_abs": self.full((G, R, W), NO_SLOT),
            "win_val": zeros(G, R, W),
        }

    def zero_outbox(self):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        pair = lambda: self.zeros(G, Rr, R)  # noqa: E731
        return {
            "flags": pair(),
            "ps_lo": pair(), "ps_hi": pair(), "ps_cbar": pair(),
            "pr_f": pair(),
            "bw_abs": self.zeros(G, Rr, W),
            "bw_val": self.zeros(G, Rr, W),
        }

    PHASES: Tuple[Tuple[str, str], ...] = (
        ("ingest_push", "_ingest_push"),
        ("ingest_push_reply", "_ingest_push_reply"),
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
        c.serving = c.rid == 0
        c.pushed = self._pushed
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

    # ---- PUSH ingest (peers): contiguous range accept
    def _ingest_push(self, s, c):
        p_valid = (c.flags & PUSH) != 0
        p_src = first_true(p_valid, 2)
        p_ok = p_valid.any(dim=2) & ~c.serving
        p_lo = take_src(c.inbox["ps_lo"], p_src)
        p_hi = take_src(c.inbox["ps_hi"], p_src)
        p_cbar = take_src(c.inbox["ps_cbar"], p_src)
        acc = p_ok & (p_lo <= s["next_slot"]) & (p_hi > s["next_slot"])
        m_acc, abs_acc = range_cover(p_lo, p_hi, self.W)
        m_acc = m_acc & acc[..., None]
        lane_val = take_lane(c.inbox["bw_val"], p_src)
        s["win_abs"] = torch.where(m_acc, abs_acc, s["win_abs"])
        s["win_val"] = torch.where(m_acc, lane_val, s["win_val"])
        s["next_slot"] = torch.where(
            acc, torch.maximum(s["next_slot"], p_hi), s["next_slot"]
        )
        c.peer_commit = p_ok
        c.new_cbar = torch.minimum(p_cbar, s["next_slot"])

    # ---- PUSH_REPLY ingest (serving node): cumulative ack frontiers
    def _ingest_push_reply(self, s, c):
        r_valid = (c.flags & PUSH_REPLY) != 0
        pr_f = c.inbox["pr_f"]
        prog = r_valid & (pr_f > s["match_f"])
        s["match_f"] = torch.where(
            r_valid, torch.maximum(s["match_f"], pr_f), s["match_f"]
        )
        s["retry_cnt"] = torch.where(prog, self.config.retry_interval,
                                     s["retry_cnt"])

    # ---- serving node proposals
    def _intake(self, s, c):
        n_new, m_new, abs_new, new_vals = client_intake(
            s, c.inputs, c.serving, self.config.max_proposals_per_tick,
            self.W,
        )
        s["win_abs"] = torch.where(m_new, abs_new, s["win_abs"])
        s["win_val"] = torch.where(m_new, new_vals, s["win_val"])
        s["next_slot"] = s["next_slot"] + n_new
        c.n_new = n_new

    # ---- durability + commit
    def _advance_bars(self, s, c):
        cfg = self.config
        s["dur_bar"] = advance_durability(s, cfg.dur_lag)
        # serving commit: all pushed peers acked (min over pushed frontiers)
        srv_commit = s["dur_bar"]
        if self._degree > 0:
            acked_min = torch.where(self._dst_pushed, s["match_f"],
                                    I32_MAX).amin(dim=2)
            srv_commit = torch.minimum(srv_commit, acked_min)
        s["commit_bar"] = torch.where(
            c.serving,
            torch.maximum(s["commit_bar"], srv_commit),
            torch.where(
                c.peer_commit,
                torch.maximum(s["commit_bar"], c.new_cbar),
                s["commit_bar"],
            ),
        )
        s["exec_bar"] = advance_exec(s, c.inputs, cfg.exec_follows_commit)

    # ---- outbox
    def _build_outbox(self, s, c):
        cfg = self.config
        out = {}
        to_pushed = c.serving[..., None] & self._dst_pushed

        stale = to_pushed & (s["next_idx"] > s["match_f"])
        s["retry_cnt"] = torch.where(
            stale, s["retry_cnt"] - 1, cfg.retry_interval
        )
        rewind = stale & (s["retry_cnt"] <= 0)
        s["next_idx"] = torch.where(rewind, s["match_f"], s["next_idx"])
        s["retry_cnt"] = torch.where(rewind, cfg.retry_interval,
                                     s["retry_cnt"])

        snd_lo = s["next_idx"]
        snd_hi = torch.minimum(s["next_slot"][..., None], snd_lo + self._chunk)
        do_push = to_pushed & (snd_hi > snd_lo)
        # heartbeat-style empty push keeps peer commit bars advancing
        # (do_push | do_note is every pushed destination)
        oflags = flag_bits(to_pushed, PUSH)
        nslot = s["next_slot"][..., None]
        out["ps_lo"] = torch.where(do_push, snd_lo, nslot)
        out["ps_hi"] = torch.where(do_push, snd_hi, nslot)
        out["ps_cbar"] = torch.where(to_pushed, s["commit_bar"][..., None], 0)
        s["next_idx"] = torch.where(do_push, snd_hi, s["next_idx"])

        # peers ack their durable contiguous frontier to the serving node
        do_reply = c.pushed[..., None] & self._to_serving
        oflags = oflags | flag_bits(do_reply, PUSH_REPLY)
        out["pr_f"] = torch.where(
            do_reply, torch.minimum(s["next_slot"], s["dur_bar"])[..., None],
            0,
        )

        out["bw_abs"] = s["win_abs"]
        out["bw_val"] = s["win_val"]
        out["flags"] = oflags
        return out
