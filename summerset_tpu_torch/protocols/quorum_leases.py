"""Vectorized QuorumLeases: MultiPaxos + quorum read leases on a
configurable grantee set, counterpart of
``summerset_tpu/protocols/quorum_leases.py`` (see its module doc for the
design: grantee confs ride the log, every replica grants counter leases to
the configured grantees, the leader's commit frontier waits for every
grantee in a live-reported grant set, and a leader-lease plane keeps the
leader stable).

The same phases run on the port's MultiPaxos skeleton through its hooks;
``win_cfg`` and the ``bw_cfg`` broadcast lane are bool as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.protocol import _set_row
from . import register_protocol
from .common import INF, arange32, first_argmax, flag_bits, range_cover, take_lane
from .multipaxos import MultiPaxosKernel, ReplicaConfigMultiPaxos

GRANT = 1024      # quorum-lease grant/refresh: grantor -> grantee
GRANT_ACK = 2048  # grantee -> grantor (liveness for refresh gating)
GSET = 4096       # per-tick outstanding-grant bitmap beacon (to the leader)


@dataclasses.dataclass
class ReplicaConfigQuorumLeases(ReplicaConfigMultiPaxos):
    """The same fields and defaults as the JAX
    ``ReplicaConfigQuorumLeases``."""

    lease_len: int = 12          # quorum-lease length granted (ticks)
    alive_timeout: int = 10      # ticks without a reply -> stop refreshing
    leader_lease_len: int = 12   # follower vote-refusal promise (ticks)
    lease_margin: int = 4        # grantor-side slack; must exceed the
                                 # network's max one-way delay in ticks
    grant_interval: int = 4      # lease refresh period (ticks)
    num_key_buckets: int = 8     # key-hash buckets for quiescence checks
    init_responders: int = 0     # initial grantee bitmap (0 = none)
    enable_leader_leases: bool = True


@register_protocol("QuorumLeases")
class QuorumLeasesKernel(MultiPaxosKernel):
    broadcast_lanes = frozenset({"bw_abs", "bw_bal", "bw_val", "bw_cfg"})

    # the grantee conf rides the log: its window lane and the applied conf
    # are part of the durable acceptor record
    DURABLE_SCALARS = MultiPaxosKernel.DURABLE_SCALARS + (
        "conf_cur", "conf_slot",
    )
    DURABLE_WINDOWS = MultiPaxosKernel.DURABLE_WINDOWS + ("win_cfg",)
    # host conf-change plane: the leader's responder-set target
    EXTRA_INPUTS = MultiPaxosKernel.EXTRA_INPUTS + (("conf_target", "g"),)

    def restore_durable(self, st, g, me, rec, floor):
        super().restore_durable(st, g, me, rec, floor)
        st["conf_cur"] = _set_row(st["conf_cur"], g, me, int(rec["conf_cur"]))
        st["conf_slot"] = _set_row(st["conf_slot"], g, me,
                                   int(rec["conf_slot"]))

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigQuorumLeases | None = None,
        device=None,
    ):
        config = config or ReplicaConfigQuorumLeases()
        if config.leader_leases:
            raise ValueError(
                "QuorumLeases carries its own leader-lease plane; use "
                "enable_leader_leases, not the base MultiPaxos flag"
            )
        super().__init__(num_groups, population, window, config, device)
        if config.hear_timeout_lo <= config.leader_lease_len:
            raise ValueError(
                "hear_timeout_lo must exceed leader_lease_len (a follower "
                "must outwait its own promise before campaigning)"
            )
        self._hold = config.lease_len + config.lease_margin

    # ------------------------------------------------------------------ state
    def _extra_state(self, st, seed):
        G, R, W = self.G, self.R, self.W
        cfg = self.config
        st.update(
            win_cfg=self.zeros(G, R, W, dtype=torch.bool),
            conf_cur=self.full((G, R), cfg.init_responders),
            conf_slot=self.full((G, R), -1),
            conf_prop=self.full((G, R), -1),
            # grantor side: per-grantee outstanding countdown
            ql_out=self.zeros(G, R, R),
            # holder side: per-grantor countdown + conf slot it bound to
            ql_in=self.zeros(G, R, R),
            ql_slot=self.full((G, R, R), -1),
            grant_cnt=self.zeros(G, R),
            # leader side: peers' reported outstanding-grant bitmaps with
            # a decay ttl; conservative full-grant init
            rep_gset=self.full((G, R, R), cfg.init_responders),
            gset_ttl=self.full((G, R, R), self._hold),
            # leader-lease countdowns; ll_left starts full (a restarted
            # replica may have promised vote refusal just before dying)
            ll_left=self.full(
                (G, R),
                cfg.leader_lease_len if cfg.enable_leader_leases else 0,
            ),
            ll_in=self.zeros(G, R, R),
            # reply-based peer liveness
            alive_cnt=self.full((G, R, R), cfg.alive_timeout),
        )

    def _extra_outbox(self, out):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        out.update(
            gr_len=self.zeros(G, Rr, R),
            gr_slot=self.zeros(G, Rr, R),
            gs_bits=self.zeros(G, Rr, R),
            bw_cfg=self.zeros(G, Rr, W, dtype=torch.bool),
        )

    # ------------------------------------------------------ lane plumbing
    def _on_accept_write(self, s, c, m_acc, a_src):
        lane_cfg = take_lane(c.inbox["bw_cfg"], a_src)
        s["win_cfg"] = torch.where(m_acc, lane_cfg, s["win_cfg"])

    def _on_adopt(self, s, c, adopt, best_src):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        lane_cfg = c.inbox["bw_cfg"][:, None, :, :].expand(G, Rr, R, W)
        best_cfg = torch.gather(lane_cfg, 2, best_src.to(torch.int64))[
            :, :, 0, :]
        s["win_cfg"] = torch.where(adopt, best_cfg, s["win_cfg"])

    def _adopt_on_win(self, s, c, win, m_re, abs_re):
        hole = m_re & (s["win_abs"] != abs_re)
        super()._adopt_on_win(s, c, win, m_re, abs_re)
        # no-op filled holes are not conf entries
        s["win_cfg"] = s["win_cfg"] & ~hole

    # ------------------------------------------------------ leader leases
    def _ingest_heartbeat(self, s, c):
        super()._ingest_heartbeat(s, c)
        cfg = self.config
        inbox = c.inbox
        # countdowns tick once per lockstep tick (the first phase to run)
        for k in ("ql_out", "ql_in", "grant_cnt", "gset_ttl", "ll_left",
                  "ll_in", "alive_cnt"):
            s[k] = torch.clamp(s[k] - 1, min=0)
        if cfg.enable_leader_leases:
            s["ll_left"] = torch.where(c.hb_ok, cfg.leader_lease_len,
                                       s["ll_left"])
        # lease-plane ingest must precede the commit tally: the write
        # barrier may never lag the ack frontiers it is compared against
        g_valid = (c.flags & GRANT) != 0
        s["ql_in"] = torch.where(g_valid, inbox["gr_len"], s["ql_in"])
        s["ql_slot"] = torch.where(g_valid, inbox["gr_slot"], s["ql_slot"])
        c.ql_ga = g_valid  # acked back to the grantor in _extra_sends
        ga_valid = (c.flags & GRANT_ACK) != 0
        s["alive_cnt"] = torch.where(ga_valid, cfg.alive_timeout,
                                     s["alive_cnt"])
        gs_valid = (c.flags & GSET) != 0
        s["rep_gset"] = torch.where(gs_valid, inbox["gs_bits"],
                                    s["rep_gset"])
        s["gset_ttl"] = torch.where(gs_valid, self._hold, s["gset_ttl"])

    def _vote_gate(self, s, c, p_bal, p_src):
        if not self.config.enable_leader_leases:
            return torch.ones((self.G, self.rows), dtype=torch.bool,
                              device=self.device)
        # refuse challengers while our promise to the current leader runs
        return (s["ll_left"] <= 0) | (p_src == s["leader"])

    def _campaign_gate(self, s, c):
        if not self.config.enable_leader_leases:
            return torch.ones((self.G, self.rows), dtype=torch.bool,
                              device=self.device)
        return s["ll_left"] <= 0

    def _ingest_hb_reply(self, s, c):
        super()._ingest_hb_reply(s, c)
        cfg = self.config
        if cfg.enable_leader_leases:
            # a heartbeat reply confirms the sender's promise; the leader's
            # belief is shortened by the margin so it expires first
            s["ll_in"] = torch.where(
                c.hbr_valid, cfg.leader_lease_len - cfg.lease_margin,
                s["ll_in"],
            )
        s["alive_cnt"] = torch.where(c.hbr_valid | c.ar_mine,
                                     cfg.alive_timeout, s["alive_cnt"])

    # ------------------------------------------------------- conf changes
    def _leader_propose(self, s, c):
        G, Rr = self.G, self.rows
        i_am_leader = (s["bal_prepared"] == s["bal_max"]) & (
            s["bal_prepared"] > 0
        )
        active_leader = i_am_leader & (s["leader"] == c.rid)
        # a deposed replica forgets its in-flight conf proposal
        s["conf_prop"] = torch.where(active_leader, s["conf_prop"], -1)
        tgt = c.inputs.get("conf_target")
        if tgt is not None:
            self._propose_conf(s, c, active_leader,
                               tgt.to(torch.int32)[:, None].expand(G, Rr))
        # (an absent target reads as -1 everywhere: no conf entry is due)
        super()._leader_propose(s, c)
        # fresh client proposals are data entries
        s["win_cfg"] = s["win_cfg"] & ~c.m_new

    def _propose_conf(self, s, c, active_leader, tgt):
        """Append one conf entry (value = the target responder bitmap)
        ahead of this tick's client batch where the leader's target is new
        and the window has room."""
        W = self.W
        space = torch.clamp(s["exec_bar"] + W - s["next_slot"], min=0)
        want = (
            active_leader
            & (tgt >= 0)
            & (tgt != s["conf_cur"])
            & (tgt != s["conf_prop"])
            & (space > 0)
        )
        n_cfg = want.to(torch.int32)
        m_cfg, abs_cfg = range_cover(s["next_slot"], s["next_slot"] + n_cfg,
                                     W)
        s["win_abs"] = torch.where(m_cfg, abs_cfg, s["win_abs"])
        s["win_bal"] = torch.where(m_cfg, s["bal_max"][..., None],
                                   s["win_bal"])
        s["win_val"] = torch.where(m_cfg, tgt[..., None], s["win_val"])
        s["win_cfg"] = s["win_cfg"] | m_cfg
        s["next_slot"] = s["next_slot"] + n_cfg
        s["conf_prop"] = torch.where(want, tgt, s["conf_prop"])

    def _exec_gate(self, s, c):
        super()._exec_gate(s, c)
        # apply the latest executed conf entry (confs apply in exec order)
        applied = (
            s["win_cfg"]
            & (s["win_abs"] >= 0)
            & (s["win_abs"] < s["exec_bar"][..., None])
            & (s["win_abs"] > s["conf_slot"][..., None])
        )
        eff = torch.where(applied, s["win_abs"], -1)
        best = eff.amax(dim=2)
        pos = first_argmax(eff, best, 2)
        newer = best > s["conf_slot"]
        val = torch.gather(s["win_val"], 2,
                           pos.to(torch.int64)[..., None])[..., 0]
        s["conf_cur"] = torch.where(newer, val, s["conf_cur"])
        s["conf_slot"] = torch.where(newer, best, s["conf_slot"])

    # ---------------------------------------------------- takeover safety
    def _try_step_up(self, s, c):
        super()._try_step_up(s, c)
        # a fresh leader assumes every peer may be granting to every
        # configured grantee until real GSET beacons or the clock say not
        win = c.win[..., None]
        s["rep_gset"] = torch.where(win, s["conf_cur"][..., None],
                                    s["rep_gset"])
        s["gset_ttl"] = torch.where(win, self._hold, s["gset_ttl"])

    def _own_gset(self, s):
        """Bitmap of grantees this replica may still have leases out to;
        the local barrier and the GSET beacon use this exact set."""
        return torch.where(s["ql_out"] > 0, self._src_bits, 0).sum(
            dim=2, dtype=torch.int32)

    def _members(self, bitmap):
        """``[..., R]`` bool: the replicas set in each int32 bitmap."""
        return ((bitmap[..., None] >> arange32(self.R, self.device)) & 1) != 0

    # ------------------------------------------------------ write barrier
    def _commit_cap(self, s, c, peer_f):
        # union of live-reported outstanding grant sets (own included)
        live_rep = torch.where(s["gset_ttl"] > 0, s["rep_gset"], 0)
        member = self._members(live_rep).any(dim=2) | self._members(
            self._own_gset(s))
        return torch.where(member, peer_f, INF).amin(dim=2)

    # ------------------------------------------------------ grants + reads
    def _extra_sends(self, s, c, out, oflags):
        cfg = self.config
        ns_mask = self._ns_mask

        # ack received grants back to their grantors
        oflags = oflags | flag_bits(c.ql_ga & ns_mask, GRANT_ACK)

        # every replica refreshes grants to alive configured grantees
        fire = s["grant_cnt"] <= 0
        s["grant_cnt"] = torch.where(fire, cfg.grant_interval, s["grant_cnt"])
        do_grant = (
            fire[..., None]
            & self._members(s["conf_cur"])
            & (s["alive_cnt"] > 0)
            & ns_mask
        )
        oflags = oflags | flag_bits(do_grant, GRANT)
        out["gr_len"] = do_grant.to(torch.int32) * cfg.lease_len
        out["gr_slot"] = torch.where(do_grant, s["conf_slot"][..., None], 0)
        s["ql_out"] = torch.where(do_grant, self._hold, s["ql_out"])

        # GSET beacon every tick (leaders may change any tick)
        oflags = oflags | flag_bits(ns_mask, GSET)
        out["gs_bits"] = torch.where(ns_mask, self._own_gset(s)[..., None], 0)
        out["bw_cfg"] = s["win_cfg"]
        return oflags

    def _telemetry(self, old, s, c) -> dict:
        """A grantor-side countdown raised above its old value is a lease
        grant or refresh issued this tick."""
        tel = super()._telemetry(old, s, c)
        tel["grants"] = (s["ql_out"] > old["ql_out"]).sum(
            dim=2, dtype=torch.int32)
        return tel

    def _effects_extra(self, s, c):
        cfg = self.config
        K = cfg.num_key_buckets
        # majority-leased: same-conf leases from a majority of grantors
        # (self counts as one)
        lease_ok = (
            (s["ql_in"] > 0)
            & (s["ql_slot"] == s["conf_slot"][..., None])
            & ~self._eye
        )
        lease_cnt = lease_ok.sum(dim=2, dtype=torch.int32) + 1
        self_member = ((s["conf_cur"] >> c.rid) & 1) != 0
        lease_held = self_member & (lease_cnt >= self.quorum)
        # pending-write buckets: un-executed tail of the own voted log
        tail = (
            (s["win_bal"] > 0)
            & (s["win_abs"] >= s["exec_bar"][..., None])
            & (s["win_abs"]
               < torch.maximum(s["vote_bar"], s["next_slot"])[..., None])
        )
        bucket = torch.remainder(s["win_val"], K)
        karange = arange32(K, self.device)[:, None]
        # the count of set bits of JAX's per-bucket pending bitmap
        n_pend = (
            tail[..., None, :] & (bucket[..., None, :] == karange)
        ).any(dim=3).sum(dim=2, dtype=torch.int32)
        n_local = torch.where(lease_held, K - n_pend, 0)
        if cfg.enable_leader_leases:
            # leader local reads under a confirmed quorum of vote promises
            ll_cnt = (s["ll_in"] > 0).sum(dim=2, dtype=torch.int32) + 1
            leader_read_ok = c.active_leader & (ll_cnt >= self.quorum)
        else:
            leader_read_ok = torch.zeros_like(c.active_leader)
        return {
            "lease_held": lease_held,
            "lease_cnt": lease_cnt,
            "n_local_buckets": n_local,
            "leader_read_ok": leader_read_ok,
            "conf_cur": s["conf_cur"],
        }
