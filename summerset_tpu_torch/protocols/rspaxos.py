"""Vectorized RSPaxos: MultiPaxos + Reed-Solomon erasure-coded payloads,
counterpart of ``summerset_tpu/protocols/rspaxos.py`` (see its module doc).

The device runs the consensus control plane over int32 value references;
the shard bytes live in the host codeword store (``host/codeword.py``),
whose GF(2^8) products run on the CUDA kernel of ``ops/rscoding.py``.
Commit needs ``quorum + fault_tolerance`` acks; a new leader adopts a
slot only when ``d`` distinct shard holders voted its value
(``prep_voters``, int32 lanes with the JAX uint32 bits); followers fill
their full-data frontier ``full_bar`` through RECON_REQ/RECON_REPLY.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import quorum as quorum_lib
from ..utils.bitmap import popcount
from . import register_protocol
from .common import NULL_VAL, flag_bits, range_cover
from .multipaxos import MultiPaxosKernel, ReplicaConfigMultiPaxos

RECON_REQ = 256    # needy replica -> all: want full data for [rq_lo, rq_hi)
RECON_REPLY = 512  # peer -> needy: my shards cover [rq_lo, rr_hi)


@dataclasses.dataclass
class ReplicaConfigRSPaxos(ReplicaConfigMultiPaxos):
    """Extends the MultiPaxos knobs."""

    fault_tolerance: int = 0     # extra acks required beyond majority
    recon_interval: int = 4      # ticks between Reconstruct read rounds


@register_protocol("RSPaxos")
class RSPaxosKernel(MultiPaxosKernel):
    # the reconstruct-request record is destination-independent too;
    # rr_hi stays pairwise (a reply's cover depends on its requester)
    TALLY_LANES = MultiPaxosKernel.TALLY_LANES + (
        "rq_bal", "rq_lo", "rq_hi",
    )

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigRSPaxos | None = None,
        device=None,
    ):
        config = config or ReplicaConfigRSPaxos()
        super().__init__(num_groups, population, window, config, device)
        # RS scheme (d, p) = (majority, population - majority)
        self.num_data = self.quorum
        self.num_parity = population - self.quorum
        if config.fault_tolerance > self.num_parity:
            raise ValueError(
                f"invalid fault_tolerance {config.fault_tolerance} "
                f"(max {self.num_parity})"
            )

    @property
    def commit_k(self) -> int:
        return self.quorum + self.config.fault_tolerance

    # ------------------------------------------------------------------ state
    def _extra_state(self, st, seed):
        G, R, W = self.G, self.R, self.W
        st.update(
            prep_voters=self.zeros(G, R, W),
            prep_pbal=self.zeros(G, R, W),
            prep_pval=self.full((G, R, W), NULL_VAL),
            full_bar=self.zeros(G, R),
            f2_lo=self.zeros(G, R),
            f2_hi=self.zeros(G, R),
            recon_cover=self.zeros(G, R, R),
            recon_cnt=self.zeros(G, R),
        )

    def _extra_outbox(self, out):
        G, Rr, R = self.G, self.rows, self.R
        rq_shape = (G, Rr) if self.collective_tally else (G, Rr, R)
        out.update(
            rq_bal=self.zeros(*rq_shape),
            rq_lo=self.zeros(*rq_shape),
            rq_hi=self.zeros(*rq_shape),
            rr_hi=self.zeros(G, Rr, R),
        )

    # ------------------------------------------------- accept-side additions
    def _ingest_accept(self, s, c):
        super()._ingest_accept(s, c)
        # a run re-based by another proposer invalidates the leader-era
        # full interval
        foreign = c.a_new_run & (c.a_src != c.rid)
        s["f2_lo"] = torch.where(foreign, s["full_bar"], s["f2_lo"])
        s["f2_hi"] = torch.where(foreign, s["full_bar"], s["f2_hi"])

    def _ingest_snapshot(self, s, c):
        super()._ingest_snapshot(s, c)
        s["full_bar"] = torch.where(
            c.sn_adv, torch.maximum(s["full_bar"], c.sn_to), s["full_bar"]
        )
        s["f2_lo"] = torch.where(c.sn_adv, c.sn_to, s["f2_lo"])
        s["f2_hi"] = torch.where(c.sn_adv, c.sn_to, s["f2_hi"])

    # --------------------------------------------- prepare-reply accumulation
    def _ingest_prepare_reply(self, s, c):
        self._prep_reply_common(s, c)
        ok = c.pr_ok
        tick_best, _, tick_val = self._best_of_senders(c)

        # count shard holders BY VALUE at any ballot (shards of one value
        # id are byte-identical whatever ballot voted them)
        higher = tick_best > s["prep_pbal"]
        new_pbal = torch.maximum(s["prep_pbal"], tick_best)
        new_pval = torch.where(higher, tick_val, s["prep_pval"])
        tick_voters = torch.where(
            ok & (c.pr_lane_val == new_pval[:, :, None, :]),
            self._src_bits[None, None, :, None],
            0,
        ).sum(dim=2, dtype=torch.int32)
        value_kept = ~higher | (tick_val == s["prep_pval"])
        s["prep_voters"] = (
            torch.where(value_kept, s["prep_voters"], 0) | tick_voters
        )
        s["prep_pbal"] = new_pbal
        s["prep_pval"] = new_pval
        self._on_prep_tally(s, c, ok, value_kept, new_pval)

    def _on_prep_tally(self, s, c, ok, value_kept, new_pval):
        """Hook: extra per-slot lanes tracked alongside the tally."""

    def _on_explode(self, s, c, explode):
        # seed the tally with the candidate's own voted window
        W = self.W
        trig = torch.where(explode, s["commit_bar"], s["prep_trigger"])
        _, abs_ad = range_cover(trig, trig + W, W)
        own_vote = (
            explode[..., None]
            & (s["win_abs"] == abs_ad)
            & (s["win_bal"] > 0)
        )
        c.own_vote = own_vote
        own_bit = torch.bitwise_left_shift(
            torch.ones_like(c.rid), c.rid
        )[..., None]
        ex = explode[..., None]
        s["prep_voters"] = torch.where(
            ex, torch.where(own_vote, own_bit, 0), s["prep_voters"]
        )
        s["prep_pbal"] = torch.where(
            ex, torch.where(own_vote, s["win_bal"], 0), s["prep_pbal"]
        )
        s["prep_pval"] = torch.where(
            ex, torch.where(own_vote, s["win_val"], NULL_VAL), s["prep_pval"]
        )

    # -------------------------------------------------- step-up + adoption
    def _prep_recover_need(self, s):
        """Hook: per-slot distinct-voter count needed to rebuild a value."""
        return self.num_data

    def _win_condition(self, s, c):
        W = self.W
        cfg = self.config
        trig = s["prep_trigger"]
        _, abs_ad = range_cover(trig, trig + W, W)
        tallied = abs_ad < s["prep_hi"][..., None]
        cnt = popcount(s["prep_voters"])
        need = self._prep_recover_need(s)
        slot_ok = ~tallied | (s["prep_pbal"] == 0) | (cnt >= need)
        acks = popcount(s["prep_acks"])
        full_quorum = acks >= (self.R - cfg.fault_tolerance)
        return c.candidate & (
            ((acks >= self.quorum) & slot_ok.all(dim=2)) | full_quorum
        )

    def _adopt_on_win(self, s, c, win, m_re, abs_re):
        # recoverable slots adopt the tallied value, the rest become no-ops,
        # all stamped at the new ballot
        cnt = popcount(s["prep_voters"])
        need = self._prep_recover_need(s)
        recover = m_re & (s["prep_pbal"] > 0) & (cnt >= need)
        s["win_val"] = torch.where(
            m_re, torch.where(recover, s["prep_pval"], NULL_VAL),
            s["win_val"],
        )
        s["win_abs"] = torch.where(m_re, abs_re, s["win_abs"])
        s["win_bal"] = torch.where(m_re, s["bal_max"][..., None],
                                   s["win_bal"])
        s["f2_lo"] = torch.where(win, s["prep_trigger"], s["f2_lo"])
        s["f2_hi"] = torch.where(win, s["next_slot"], s["f2_hi"])

    def _leader_propose(self, s, c):
        super()._leader_propose(s, c)
        # fresh proposals carry full batches at the leader
        s["f2_hi"] = torch.where(
            c.active_leader, torch.maximum(s["f2_hi"], s["next_slot"]),
            s["f2_hi"],
        )

    # ------------------------------------------------- execution gating
    def _exec_gate(self, s, c):
        s["full_bar"] = torch.where(
            s["full_bar"] >= s["f2_lo"],
            torch.maximum(s["full_bar"], s["f2_hi"]),
            s["full_bar"],
        )
        if self.config.exec_follows_commit:
            s["exec_bar"] = torch.minimum(s["commit_bar"], s["full_bar"])
        else:
            s["exec_bar"] = torch.maximum(
                s["exec_bar"],
                torch.minimum(
                    torch.minimum(s["commit_bar"], s["full_bar"]),
                    c.inputs["exec_floor"].to(torch.int32),
                ),
            )

    # ------------------------------------------------- reconstruction reads
    def _extra_sends(self, s, c, out, oflags):
        cfg = self.config
        ns_mask = self._ns_mask
        inbox = c.inbox

        # ingest RECON_REPLY: per-peer cover frontiers (monotone)
        rr_valid = (c.flags & RECON_REPLY) != 0
        s["recon_cover"] = torch.where(
            rr_valid,
            torch.maximum(s["recon_cover"], inbox["rr_hi"]),
            s["recon_cover"],
        )
        # own shards count within the current ballot-safe run
        own_cover = torch.where(
            s["vote_from"] <= s["full_bar"], s["vote_bar"], s["full_bar"]
        )
        cover = torch.where(self._eye, own_cover[..., None],
                            s["recon_cover"])
        self._advance_full_bar(s, cover)

        # send RECON_REQ every recon_interval ticks while starved
        goal = self._recon_goal(s)
        needy = s["full_bar"] < goal
        s["recon_cnt"] = torch.where(needy, s["recon_cnt"] - 1,
                                     cfg.recon_interval)
        fire = needy & (s["recon_cnt"] <= 0)
        s["recon_cnt"] = torch.where(fire, cfg.recon_interval,
                                     s["recon_cnt"])
        do_rq = fire[..., None] & ns_mask
        oflags = oflags | flag_bits(do_rq, RECON_REQ)
        if self.collective_tally:
            out["rq_bal"] = quorum_lib.source_lane(fire, s["bal_max"])
            out["rq_lo"] = quorum_lib.source_lane(fire, s["full_bar"])
            out["rq_hi"] = quorum_lib.source_lane(fire, goal)
        else:
            out["rq_bal"] = torch.where(do_rq, s["bal_max"][..., None], 0)
            out["rq_lo"] = torch.where(do_rq, s["full_bar"][..., None], 0)
            out["rq_hi"] = torch.where(do_rq, goal[..., None], 0)

        # serve RECON_REQ: my run covers [rq_lo, min(rq_hi, vote_bar)) iff
        # it reaches back to rq_lo at a ballot >= the requester's bal_max
        rq = quorum_lib.pair_views(
            inbox, ("rq_bal", "rq_lo", "rq_hi"), self.collective_tally
        )
        rq_valid = (c.flags & RECON_REQ) != 0
        can_serve = (
            rq_valid
            & (s["vote_bal"][..., None] >= rq["rq_bal"])
            & (s["vote_from"][..., None] <= rq["rq_lo"])
        )
        cover_hi = torch.where(
            can_serve,
            torch.minimum(rq["rq_hi"], s["vote_bar"][..., None]),
            0,
        )
        # the inbox is receiver-oriented [G, self, src], so the reply to
        # each requester is the outbox's [G, self, dst=src] layout
        do_rr = can_serve & (cover_hi > rq["rq_lo"]) & ns_mask
        oflags = oflags | flag_bits(do_rr, RECON_REPLY)
        out["rr_hi"] = torch.where(do_rr, cover_hi, 0)
        return oflags

    def _advance_full_bar(self, s, cover):
        """Hook: advance the contiguous full-data frontier."""
        d_cover = quorum_lib.quorum_frontier(cover, self.num_data)
        s["full_bar"] = torch.minimum(
            torch.maximum(torch.maximum(s["full_bar"], d_cover),
                          s["full_bar"]),
            s["commit_bar"],
        )

    def _recon_goal(self, s):
        """Hook: upper end of the wanted reconstruct range."""
        return s["commit_bar"]

    def _effects_extra(self, s, c):
        return {"full_bar": s["full_bar"]}
