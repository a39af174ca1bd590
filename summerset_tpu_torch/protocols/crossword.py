"""Vectorized Crossword: RSPaxos with a tunable per-slot shard assignment,
counterpart of ``summerset_tpu/protocols/crossword.py`` (see its module
doc).

Each slot carries its assignment width ``win_spr`` (replica ``r`` holds
shards ``[r * dj, r * dj + spr) mod T`` of a width-``T`` codeword, ``dj =
T // R``), stamped by the leader at propose time and carried in the
``bw_spr`` lane.  A slot of width ``spr`` commits once ``max(majority, f
+ 1 + ceil((d - spr) / dj))`` ack frontiers pass it, and becomes full
data once ``1 + ceil((d - spr) / dj)`` cover frontiers do: both are one
``coverage_frontier`` reduction.  The leader picks the smallest viable
width from per-peer responsiveness, or the host's ``spr_override``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import quorum as quorum_lib
from . import register_protocol
from .common import range_cover, take_lane
from .rspaxos import ReplicaConfigRSPaxos, RSPaxosKernel


@dataclasses.dataclass
class ReplicaConfigCrossword(ReplicaConfigRSPaxos):
    """Extends the RSPaxos knobs."""

    rs_total_shards: int = 0    # codeword width T; 0 = population
    rs_data_shards: int = 0     # data shards d; 0 = majority * dj
    init_spr: int = 0           # initial shards per replica; 0 = dj
    assignment_adaptive: bool = True   # re-pick spr from live responsiveness
    lag_threshold: int = 8      # ticks without ack/hb-reply -> unresponsive
    gossip_tail_ignores: int = 0  # freshest slots exempt from gossip rounds


@register_protocol("Crossword")
class CrosswordKernel(RSPaxosKernel):
    broadcast_lanes = frozenset({"bw_abs", "bw_bal", "bw_val", "bw_spr"})

    # the voted value's assignment width is voted content
    DURABLE_WINDOWS = RSPaxosKernel.DURABLE_WINDOWS + ("win_spr",)
    EXTRA_INPUTS = RSPaxosKernel.EXTRA_INPUTS + (("spr_override", "g"),)

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigCrossword | None = None,
        device=None,
    ):
        config = config or ReplicaConfigCrossword()
        super().__init__(num_groups, population, window, config, device)
        T = config.rs_total_shards or population
        if T % population != 0:
            raise ValueError("rs_total_shards must be a multiple of population")
        self.total_shards = T
        self.dj = T // population
        d = config.rs_data_shards or self.quorum * self.dj
        if not self.dj <= d <= T:
            raise ValueError(f"invalid rs_data_shards {d} (T={T}, dj={self.dj})")
        self.data_shards = d
        spr0 = config.init_spr or self.dj
        if not self.dj <= spr0 <= d:
            raise ValueError(f"invalid init_spr {spr0} (dj={self.dj}, d={d})")
        self.init_spr = spr0

    # ------------------------------------------------------------- need math
    def _cdiv_pos(self, x):
        """max(0, ceil(x / dj)) elementwise, int32."""
        return torch.clamp(
            -torch.div(-x, self.dj, rounding_mode="floor"), min=0
        )

    def _commit_need(self, spr):
        """Acks required to commit a slot of width ``spr``: a quorum and
        worst-case (f+1-survivor) coverage >= d."""
        f = self.config.fault_tolerance
        cov = f + 1 + self._cdiv_pos(self.data_shards - spr)
        return torch.clamp(cov, min=self.quorum)

    def _recover_need(self, spr):
        """Distinct cover frontiers needed to rebuild a slot of width
        ``spr``."""
        return 1 + self._cdiv_pos(self.data_shards - spr)

    # ------------------------------------------------------------------ state
    def _extra_state(self, st, seed):
        super()._extra_state(st, seed)
        G, R, W = self.G, self.R, self.W
        d = self.data_shards
        st.update(
            # per-slot assignment width lane (full-copy-safe default)
            win_spr=self.full((G, R, W), d),
            # candidate-side min voter width of the tallied value
            prep_pspr=self.full((G, R, W), d),
            # adaptive policy: per-peer staleness + current choice
            lag_cnt=self.zeros(G, R, R),
            cur_spr=self.full((G, R), self.init_spr),
        )

    def _extra_outbox(self, out):
        super()._extra_outbox(out)
        out["bw_spr"] = self.zeros(self.G, self.rows, self.W)

    # --------------------------------------------------- accept-side additions
    def _on_accept_write(self, s, c, m_acc, a_src):
        super()._on_accept_write(s, c, m_acc, a_src)
        lane_spr = take_lane(c.inbox["bw_spr"], a_src)
        s["win_spr"] = torch.where(m_acc, lane_spr, s["win_spr"])

    # ---------------------------------------------- prepare tally extensions
    def _on_prep_tally(self, s, c, ok, value_kept, new_pval):
        # recoverability assumes the narrowest width any voter of the
        # tallied value held it under
        d = self.data_shards
        lane_spr = torch.clamp(c.inbox["bw_spr"][:, None, :, :], max=d)
        contrib = ok & (c.pr_lane_val == new_pval[:, :, None, :])
        tick_min = torch.where(contrib, lane_spr, d).amin(dim=2)
        base = torch.where(value_kept, s["prep_pspr"], d)
        s["prep_pspr"] = torch.minimum(base, tick_min)

    def _on_explode(self, s, c, explode):
        super()._on_explode(s, c, explode)
        d = self.data_shards
        s["prep_pspr"] = torch.where(
            explode[..., None],
            torch.where(c.own_vote, torch.clamp(s["win_spr"], max=d), d),
            s["prep_pspr"],
        )

    # -------------------------------------------------- step-up + adoption
    def _prep_recover_need(self, s):
        return self._recover_need(s["prep_pspr"])

    def _adopt_on_win(self, s, c, win, m_re, abs_re):
        super()._adopt_on_win(s, c, win, m_re, abs_re)
        # re-proposals are re-encoded under the winner's current assignment
        s["win_spr"] = torch.where(m_re, s["cur_spr"][..., None],
                                   s["win_spr"])

    # ------------------------------------------------ adaptive policy + intake
    def _leader_propose(self, s, c):
        cfg = self.config
        d, dj, f = self.data_shards, self.dj, cfg.fault_tolerance
        prog = c.ar_prog | c.hbr_valid
        s["lag_cnt"] = torch.where(prog, 0, s["lag_cnt"] + 1)
        if cfg.assignment_adaptive:
            resp = 1 + (
                self._ns_mask & (s["lag_cnt"] < cfg.lag_threshold)
            ).sum(dim=2, dtype=torch.int32)
            choice = torch.clamp(d - (resp - 1 - f) * dj, self.init_spr, d)
        else:
            choice = self.full((self.G, self.rows), self.init_spr)
        # the host's perf models may override the choice per group
        if "spr_override" in c.inputs:
            ov = c.inputs["spr_override"].to(torch.int32)[:, None]  # [G, 1]
            choice = torch.where(ov > 0, torch.clamp(ov, dj, d), choice)
        s["cur_spr"] = choice
        super()._leader_propose(s, c)
        # an instance's assignment is fixed at propose time: pending narrow
        # slots stall the commit frontier until peers heal
        s["win_spr"] = torch.where(c.m_new, s["cur_spr"][..., None],
                                   s["win_spr"])

    # ----------------------------------------------- per-slot commit tally
    def _tally_frontier(self, s, c, peer_f):
        """Shard-coverage quorum as one ``coverage_frontier`` reduction
        over the ``[G, R, R_peer, W]`` ack-vs-slot bitmap."""
        W = self.W
        _, abs_w = range_cover(s["commit_bar"], s["commit_bar"] + W, W)
        fail_abs = quorum_lib.coverage_frontier(
            peer_f, abs_w,
            need=self._commit_need(s["win_spr"]),
            slot_known=s["win_abs"] == abs_w,
            in_rng=abs_w < s["next_slot"][..., None],
        )
        return torch.minimum(fail_abs, s["next_slot"])

    # ------------------------------------------- per-slot gossip cover tally
    def _advance_full_bar(self, s, cover):
        W = self.W
        _, abs_w = range_cover(s["full_bar"], s["full_bar"] + W, W)
        fail_abs = quorum_lib.coverage_frontier(
            cover, abs_w,
            need=self._recover_need(s["win_spr"]),
            slot_known=s["win_abs"] == abs_w,
            in_rng=abs_w < s["commit_bar"][..., None],
        )
        s["full_bar"] = torch.minimum(
            torch.maximum(torch.minimum(fail_abs, s["commit_bar"]),
                          s["full_bar"]),
            s["commit_bar"],
        )

    def _recon_goal(self, s):
        tail = self.config.gossip_tail_ignores
        if tail <= 0:
            return s["commit_bar"]
        return torch.maximum(s["full_bar"], s["commit_bar"] - tail)

    def _extra_sends(self, s, c, out, oflags):
        out["bw_spr"] = s["win_spr"]
        return super()._extra_sends(s, c, out, oflags)

    def _effects_extra(self, s, c):
        fx = super()._effects_extra(s, c)
        fx["cur_spr"] = s["cur_spr"]
        return fx
