"""Vectorized CRaft: Raft + Reed-Solomon erasure coding with full-copy
fallback, counterpart of ``summerset_tpu/protocols/craft.py`` (see its
module doc).

Each appended entry is stamped coded or full-copy (``win_full``, carried
to followers in the bool ``bw_full`` lane) from the leader's live peer
count at append time; a coded slot commits at ``majority +
fault_tolerance`` acks, a full-copy slot at ``majority``, walked slot by
slot from ``commit_bar``.  Followers execute only below their full-data
frontier ``full_bar``, healed by RECON_REQ/RECON_REPLY shard and full
covers.  The shard bytes live in the host codeword store, RS(d =
majority, p = population - majority), replica ``r`` holding shard ``r``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import register_protocol
from .common import I32_MAX, flag_bits, kth_largest, range_cover, take_lane
from .raft import RaftKernel, ReplicaConfigRaft

RECON_REQ = 128    # needy replica -> all: want full data for [rq_lo, rq_hi)
RECON_REPLY = 256  # peer -> needy: shard cover rr_hi, full cover rr_fhi


@dataclasses.dataclass
class ReplicaConfigCRaft(ReplicaConfigRaft):
    """Extends the Raft knobs."""

    fault_tolerance: int = 0     # extra acks required for coded commits
    recon_interval: int = 4      # ticks between Reconstruct read rounds
    alive_timeout: int = 20      # ticks without any reply -> peer dead


@register_protocol("CRaft")
class CRaftKernel(RaftKernel):
    broadcast_lanes = frozenset({"bw_abs", "bw_term", "bw_val", "bw_full"})

    # the per-slot mode bit is voted content (the commit tally reads it)
    DURABLE_WINDOWS = RaftKernel.DURABLE_WINDOWS + ("win_full",)

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigCRaft | None = None,
        device=None,
    ):
        config = config or ReplicaConfigCRaft()
        super().__init__(num_groups, population, window, config, device)
        self.num_data = self.quorum
        self.num_parity = population - self.quorum
        if config.fault_tolerance > self.num_parity:
            raise ValueError(
                f"invalid fault_tolerance {config.fault_tolerance} "
                f"(max {self.num_parity})"
            )

    # ------------------------------------------------------------------ state
    def _extra_state(self, st, seed):
        G, R, W = self.G, self.R, self.W
        st.update(
            win_full=self.zeros(G, R, W, dtype=torch.bool),
            # leader-side conservative peer liveness countdowns
            alive_cnt=self.full((G, R, R), self.config.alive_timeout),
            # full-data frontier + reconstruction bookkeeping
            full_bar=self.zeros(G, R),
            recon_cover=self.zeros(G, R, R),
            recon_fcover=self.zeros(G, R, R),
            recon_cnt=self.zeros(G, R),
        )

    def _extra_outbox(self, out):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        out.update(
            rq_lo=self.zeros(G, Rr, R),
            rq_hi=self.zeros(G, Rr, R),
            rr_hi=self.zeros(G, Rr, R),
            rr_fhi=self.zeros(G, Rr, R),
            bw_full=self.zeros(G, Rr, W, dtype=torch.bool),
        )

    # ---------------------------------------------------- mode-bit plumbing
    def _on_ae_write(self, s, c, m_acc, a_src):
        lane_full = take_lane(c.inbox["bw_full"], a_src)
        s["win_full"] = torch.where(m_acc, lane_full, s["win_full"])

    def _append_mode(self, s, c):
        # full-copy when more than `fault_tolerance` peers look dead; the
        # own column never decays, so the mode heals once peers return
        n_dead = (s["alive_cnt"] <= 0).sum(dim=2, dtype=torch.int32)
        return n_dead > self.config.fault_tolerance

    def _on_append(self, s, c, m_new, mode):
        s["win_full"] = torch.where(m_new, mode[..., None], s["win_full"])

    def _leader_append(self, s, c):
        super()._leader_append(s, c)
        # in fallback the leader also re-stamps its pending own-term tail
        # [commit_bar, log_end) full-copy, so the whole frontier can commit
        # at the majority threshold (it holds their full batches)
        mode = self._append_mode(s, c)
        m, abs_s = range_cover(s["commit_bar"], s["log_end"], self.W)
        restamp = (
            (s["is_leader"] & mode)[..., None]
            & m
            & (s["win_abs"] == abs_s)
            & (abs_s >= s["own_from"][..., None])
        )
        s["win_full"] = s["win_full"] | restamp

    def _try_win(self, s, c):
        super()._try_win(s, c)
        # a fresh leader starts from optimistic liveness (coded mode)
        s["alive_cnt"] = torch.where(
            c.win[..., None], self.config.alive_timeout, s["alive_cnt"]
        )

    # --------------------------------------------------- liveness countdown
    def _ingest_ae_reply(self, s, c):
        super()._ingest_ae_reply(s, c)
        # any reply (vote, append or recon) refreshes the sender's liveness
        heard = c.ar_valid | c.vr_valid | ((c.flags & RECON_REPLY) != 0)
        s["alive_cnt"] = torch.where(
            heard | self._eye,
            self.config.alive_timeout,
            s["alive_cnt"] - s["is_leader"][..., None].to(torch.int32),
        )

    # ------------------------------------------- per-slot-threshold commit
    def _commit_frontier(self, s, c, peer_f):
        W = self.W
        f_full = kth_largest(peer_f, self.quorum)
        f_coded = kth_largest(
            peer_f, self.quorum + self.config.fault_tolerance
        )
        # walk the window from commit_bar: slot a commits iff its own
        # stamped threshold frontier exceeds a, and all before it did
        m, abs_s = range_cover(s["commit_bar"], s["log_end"], W)
        thresh = torch.where(s["win_full"], f_full[..., None],
                             f_coded[..., None])
        in_win = s["win_abs"] == abs_s
        ok = (~m) | (in_win & (thresh > abs_s))
        # first failing absolute slot = the new commit frontier
        fail_at = torch.where(m & ~ok, abs_s, I32_MAX)
        return torch.minimum(fail_at.amin(dim=2), s["log_end"])

    # ------------------------------------------------- execution gating
    def _exec_gate(self, s, c):
        W = self.W
        # full-copy slots extend the full frontier directly; coded slots at
        # followers need recon covers (d shard covers or one full cover)
        own_shard_cover = torch.where(self._eye, I32_MAX, s["recon_cover"])
        d_cover = (
            kth_largest(own_shard_cover, self.num_data)
            if self.num_data > 1
            else s["commit_bar"]
        )
        f_cover = s["recon_fcover"].amax(dim=2)
        healed = torch.maximum(d_cover, f_cover)

        m, abs_s = range_cover(s["full_bar"], s["commit_bar"], W)
        in_win = s["win_abs"] == abs_s
        slot_full = (in_win & s["win_full"]) | (abs_s < healed[..., None])
        ok = (~m) | slot_full
        fail_at = torch.where(m & ~ok, abs_s, I32_MAX)
        # jnp.clip order: the lower bound first, then the upper one
        s["full_bar"] = torch.minimum(
            torch.maximum(fail_at.amin(dim=2), s["full_bar"]),
            s["commit_bar"],
        )
        # leaders hold full batches for their own appends [own_from, end)
        s["full_bar"] = torch.where(
            s["is_leader"] & (s["full_bar"] >= s["own_from"]),
            torch.maximum(s["full_bar"], s["commit_bar"]),
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

    def _ingest_snapshot(self, s, c):
        super()._ingest_snapshot(s, c)
        s["full_bar"] = torch.where(
            c.sn_adv, torch.maximum(s["full_bar"], c.sn_to), s["full_bar"]
        )

    # ------------------------------------------------- reconstruction reads
    def _extra_sends(self, s, c, out, oflags):
        cfg = self.config
        ns_mask = self._ns_mask
        inbox = c.inbox

        # ingest RECON_REPLY covers (monotone: committed values never change)
        rr_valid = (c.flags & RECON_REPLY) != 0
        s["recon_cover"] = torch.where(
            rr_valid,
            torch.maximum(s["recon_cover"], inbox["rr_hi"]),
            s["recon_cover"],
        )
        s["recon_fcover"] = torch.where(
            rr_valid,
            torch.maximum(s["recon_fcover"], inbox["rr_fhi"]),
            s["recon_fcover"],
        )

        # send RECON_REQ while starved
        needy = s["full_bar"] < s["commit_bar"]
        s["recon_cnt"] = torch.where(needy, s["recon_cnt"] - 1,
                                     cfg.recon_interval)
        fire = needy & (s["recon_cnt"] <= 0)
        s["recon_cnt"] = torch.where(fire, cfg.recon_interval,
                                     s["recon_cnt"])
        do_rq = fire[..., None] & ns_mask
        oflags = oflags | flag_bits(do_rq, RECON_REQ)
        out["rq_lo"] = torch.where(do_rq, s["full_bar"][..., None], 0)
        out["rq_hi"] = torch.where(do_rq, s["commit_bar"][..., None], 0)

        # serve RECON_REQ below my own commit bar (the committed prefix is
        # unique, so my shards there match any other server's)
        rq_valid = (c.flags & RECON_REQ) != 0
        shard_hi = torch.minimum(
            inbox["rq_hi"],
            torch.minimum(s["commit_bar"], s["match_bar"])[..., None],
        )
        full_hi = torch.minimum(inbox["rq_hi"], s["full_bar"][..., None])
        do_rr = (
            rq_valid
            & ((shard_hi > inbox["rq_lo"]) | (full_hi > inbox["rq_lo"]))
            & ns_mask
        )
        oflags = oflags | flag_bits(do_rr, RECON_REPLY)
        out["rr_hi"] = torch.where(do_rr, shard_hi, 0)
        out["rr_fhi"] = torch.where(do_rr, full_hi, 0)

        # the mode-bit lane rides with the log content lanes
        out["bw_full"] = s["win_full"]
        return oflags

    def _effects_extra(self, s, c):
        return {"full_bar": s["full_bar"]}
