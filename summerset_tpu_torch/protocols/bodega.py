"""Vectorized Bodega: roster-leased always-local linearizable reads,
counterpart of ``summerset_tpu/protocols/bodega.py`` (see its module doc
for the design: a ballot-numbered roster of leader and per-bucket
responders installed through all-to-all config leases with
revoke-then-adopt, epoch-tagged consensus traffic, a per-slot write
barrier over every responder of the written bucket, and conf failover on
silent peers).

The same phases run on the port's MultiPaxos skeleton through its hooks;
the uint32 ``flags`` lane is int32 with the same bits, so the epoch gate
clears ``EPOCH_BITS`` with the same mask, and ``win_noop`` / ``bw_noop``
are bool as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from . import register_protocol
from .common import (
    INF,
    arange32,
    first_argmax,
    flag_bits,
    initial_ballot,
    kth_largest,
    make_greater_ballot,
    range_cover,
    take_lane,
    take_src,
)
from .multipaxos import (
    ACCEPT,
    HEARTBEAT,
    PREPARE,
    SNAPSHOT,
    MultiPaxosKernel,
    ReplicaConfigMultiPaxos,
)

CONF = 1024          # conf broadcast (doubles as the sender's epoch tag)
GRANT = 2048         # config-lease grant/refresh
REVOKE = 4096        # active revoke request
REVOKE_REPLY = 8192  # holder confirms the lease is dropped
AN = 16384           # accept-frontier notice (AcceptNotice analog)

EPOCH_BITS = ACCEPT | PREPARE | HEARTBEAT | SNAPSHOT


@dataclasses.dataclass
class ReplicaConfigBodega(ReplicaConfigMultiPaxos):
    """The same fields and defaults as the JAX ``ReplicaConfigBodega``."""

    lease_len: int = 12          # config lease length granted (ticks)
    lease_margin: int = 4        # grantor-side slack > max one-way delay
    grant_interval: int = 4      # lease refresh period (ticks)
    num_key_buckets: int = 8     # key-hash buckets (host KeyRangeMap folds)
    init_responders: int = 0     # initial all-bucket responders bitmap
    conf_timeout: int = 40       # ticks without hearing a peer -> failover


@register_protocol("Bodega")
class BodegaKernel(MultiPaxosKernel):
    broadcast_lanes = frozenset(
        {"bw_abs", "bw_bal", "bw_val", "bw_noop", "cf_resp"}
    )

    # the no-op marker lane is voted window content (the conf itself is
    # lease-installed, not logged: a restarted replica re-learns it)
    DURABLE_WINDOWS = MultiPaxosKernel.DURABLE_WINDOWS + ("win_noop",)
    # host conf-change plane: the announcing replica + leader/responder
    # targets + optional key bucket
    EXTRA_INPUTS = MultiPaxosKernel.EXTRA_INPUTS + (
        ("conf_init", "g"),
        ("conf_leader_target", "g"),
        ("conf_resp_target", "g"),
        ("conf_bucket", "g"),
    )

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigBodega | None = None,
        device=None,
    ):
        config = config or ReplicaConfigBodega()
        if config.leader_leases:
            raise ValueError(
                "Bodega's roster leases subsume leader leases; the base "
                "MultiPaxos leader_leases flag is not supported here"
            )
        super().__init__(num_groups, population, window, config, device)
        if config.num_key_buckets > 30:
            raise ValueError("num_key_buckets must be <= 30 (int32 bitmaps)")
        self._karange = arange32(config.num_key_buckets, self.device)
        self._kbits = torch.bitwise_left_shift(
            torch.ones_like(self._karange), self._karange
        )

    # ------------------------------------------------------------------ state
    def _extra_state(self, st, seed):
        G, R, K = self.G, self.R, self.config.num_key_buckets
        cfg = self.config
        # warm-start roster mirrors the warm-start leader
        if cfg.init_leader >= 0:
            bal0, lead0 = initial_ballot(cfg.init_leader), cfg.init_leader
        else:
            bal0, lead0 = 0, -1
        st.update(
            conf_bal=self.full((G, R), bal0),
            conf_leader=self.full((G, R), lead0),
            conf_resp=self.full((G, R, K), cfg.init_responders),
            pend_bal=self.zeros(G, R),
            pend_leader=self.full((G, R), -1),
            pend_resp=self.zeros(G, R, K),
            # all-to-all lease countdowns + the conf ballot they bind to
            lease_out=self.zeros(G, R, R),
            lease_in=self.zeros(G, R, R),
            in_bal=self.zeros(G, R, R),
            grant_cnt=self.zeros(G, R),
            # grant-time peer accept bars -> peer_accept_max
            pab=self.full((G, R, R), INF),
            pam=self.full((G, R), INF),
            # AN-fed peer liveness for conf failover
            conf_alive=self.full((G, R, R), cfg.conf_timeout),
            # explicit no-op marks (value id 0 is a legal id)
            win_noop=self.zeros(G, R, self.W, dtype=torch.bool),
        )

    def _extra_outbox(self, out):
        G, Rr, R, K = self.G, self.rows, self.R, self.config.num_key_buckets
        pair = lambda: self.zeros(G, Rr, R)  # noqa: E731
        out.update(
            cf_bal=pair(), cf_leader=pair(),
            cf_resp=self.zeros(G, Rr, K),
            gr_len=pair(), gr_bal=pair(), gr_abar=pair(),
            rv_bal=pair(), rvr_bal=pair(),
            bw_noop=self.zeros(G, Rr, self.W, dtype=torch.bool),
        )

    # ------------------------------------------------- conf + lease ingest
    def _ingest_heartbeat(self, s, c):
        cfg = self.config
        G, Rr, R = self.G, self.rows, self.R
        inbox = c.inbox
        flags = c.flags
        eye = self._eye

        # epoch gate: defer consensus traffic from senders whose installed
        # conf differs from ours (an absent CONF bit reads as cf_bal 0)
        cf_valid = (flags & CONF) != 0
        epoch_ok = (
            torch.where(cf_valid, inbox["cf_bal"], 0)
            == s["conf_bal"][..., None]
        )
        c.flags = torch.where(epoch_ok, flags, flags & ~EPOCH_BITS)

        super()._ingest_heartbeat(s, c)

        # countdowns tick once per lockstep tick
        for k in ("lease_out", "lease_in", "grant_cnt", "conf_alive"):
            s[k] = torch.clamp(s[k] - 1, min=0)

        # --- CONF ingest: stage the highest conf ballot heard as pending
        eff = torch.where(cf_valid, inbox["cf_bal"], -1)
        best = eff.amax(dim=2)
        src = first_argmax(eff, best, 2)
        newer = (best > s["conf_bal"]) & (best > s["pend_bal"])
        s["pend_leader"] = torch.where(
            newer, take_src(inbox["cf_leader"], src), s["pend_leader"]
        )
        new_resp = take_lane(inbox["cf_resp"], src)  # [G, R, K]
        s["pend_resp"] = torch.where(newer[..., None], new_resp,
                                     s["pend_resp"])
        s["pend_bal"] = torch.where(newer, best, s["pend_bal"])

        # --- REVOKE ingest: drop held leases, confirm to the grantor
        # echoing the revoke's conf ballot
        rv_valid = (c.flags & REVOKE) != 0
        s["lease_in"] = torch.where(rv_valid, 0, s["lease_in"])
        c.rv_reply = rv_valid
        c.rv_echo = inbox["rv_bal"]
        # REVOKE_REPLY ingest: release only on the still-installed ballot
        rr_valid = ((c.flags & REVOKE_REPLY) != 0) & (
            inbox["rvr_bal"] == s["conf_bal"][..., None]
        )
        s["lease_out"] = torch.where(rr_valid, 0, s["lease_out"])

        # --- GRANT ingest: hold the lease, learn grant-time accept bars
        g_valid = (c.flags & GRANT) != 0
        s["lease_in"] = torch.where(g_valid, inbox["gr_len"], s["lease_in"])
        s["in_bal"] = torch.where(g_valid, inbox["gr_bal"], s["in_bal"])
        g_cur = g_valid & (inbox["gr_bal"] == s["conf_bal"][..., None])
        s["pab"] = torch.where(g_cur, inbox["gr_abar"], s["pab"])

        # --- AN ingest: per-tick liveness beacon (not a commit fast path:
        # see the JAX module's NOTE)
        an_valid = (c.flags & AN) != 0
        s["conf_alive"] = torch.where(an_valid | eye, cfg.conf_timeout,
                                      s["conf_alive"])

        # --- conf failover: a conf member went silent -> stage a filtered
        # conf at a higher ballot
        dead = (s["conf_alive"] <= 0) & ~eye  # [G, R, R_peer]
        dead_bits = torch.where(dead, self._src_bits, 0).sum(
            dim=2, dtype=torch.int32)
        lead_dead = (s["conf_leader"] >= 0) & (
            ((dead_bits >> torch.clamp(s["conf_leader"], 0, R - 1)) & 1) != 0
        )
        in_roster = (
            ((s["conf_resp"] & dead_bits[..., None]) != 0).any(dim=2)
            | lead_dead
        )
        fire = (
            in_roster
            & (s["pend_bal"] <= s["conf_bal"])
            & (s["conf_bal"] > 0)
        )
        new_bal = make_greater_ballot(
            torch.maximum(s["bal_max"], s["pend_bal"]), c.rid
        )
        s["pend_leader"] = torch.where(
            fire, torch.where(lead_dead, c.rid, s["conf_leader"]),
            s["pend_leader"],
        )
        s["pend_resp"] = torch.where(
            fire[..., None], s["conf_resp"] & ~dead_bits[..., None],
            s["pend_resp"],
        )
        s["pend_bal"] = torch.where(fire, new_bal, s["pend_bal"])

        # --- host-initiated conf change: inputs name the announcing
        # replica + targets
        if c.inputs.get("conf_init") is not None:
            def per_row(name):
                return c.inputs[name].to(torch.int32)[:, None].expand(G, Rr)

            init = per_row("conf_init")
            lead_t = per_row("conf_leader_target")
            resp_t = per_row("conf_resp_target")
            if c.inputs.get("conf_bucket") is None:
                bucket_t = self.full((G, Rr), -1)
            else:
                bucket_t = per_row("conf_bucket")
            want = (init == c.rid) & (s["pend_bal"] <= s["conf_bal"])
            new_bal2 = make_greater_ballot(
                torch.maximum(s["bal_max"], s["pend_bal"]), c.rid
            )
            sel = (bucket_t[..., None] < 0) | (
                self._karange == bucket_t[..., None]
            )
            s["pend_resp"] = torch.where(
                want[..., None] & sel,
                resp_t[..., None],
                torch.where(want[..., None], s["conf_resp"], s["pend_resp"]),
            )
            s["pend_leader"] = torch.where(want, lead_t, s["pend_leader"])
            s["pend_bal"] = torch.where(want, new_bal2, s["pend_bal"])

        # --- install the pending conf once every outgoing lease at the
        # old conf has lapsed (the revoke-then-adopt barrier)
        pending = s["pend_bal"] > s["conf_bal"]
        clear = s["lease_out"].amax(dim=2) <= 0
        install = pending & clear
        s["conf_bal"] = torch.where(install, s["pend_bal"], s["conf_bal"])
        s["conf_leader"] = torch.where(install, s["pend_leader"],
                                       s["conf_leader"])
        s["conf_resp"] = torch.where(install[..., None], s["pend_resp"],
                                     s["conf_resp"])
        s["bal_max"] = torch.maximum(s["bal_max"], s["conf_bal"])
        s["pab"] = torch.where(install[..., None], INF, s["pab"])
        s["pam"] = torch.where(install, INF, s["pam"])
        c.conf_pending = pending & ~install

        # new-conf leader steps up through the normal campaign path
        stepup = (
            install
            & (s["pend_leader"] == c.rid)
            & (s["bal_prepared"] < s["conf_bal"])
        )
        s["hb_cnt"] = torch.where(stepup, 0, s["hb_cnt"])

        # pam: min-over-time of the quorum-th smallest grant-time bar
        pab_eff = torch.where(eye, s["vote_bar"][..., None], s["pab"])
        q_small = kth_largest(pab_eff, R - self.quorum + 1)
        s["pam"] = torch.minimum(s["pam"], q_small)

    # --------------------------------------------------- no-op lane plumbing
    def _on_accept_write(self, s, c, m_acc, a_src):
        lane = take_lane(c.inbox["bw_noop"], a_src)
        s["win_noop"] = torch.where(m_acc, lane, s["win_noop"])

    def _on_adopt(self, s, c, adopt, best_src):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        lane = c.inbox["bw_noop"][:, None, :, :].expand(G, Rr, R, W)
        best = torch.gather(lane, 2, best_src.to(torch.int64))[:, :, 0, :]
        s["win_noop"] = torch.where(adopt, best, s["win_noop"])

    def _adopt_on_win(self, s, c, win, m_re, abs_re):
        hole = m_re & (s["win_abs"] != abs_re)
        super()._adopt_on_win(s, c, win, m_re, abs_re)
        s["win_noop"] = s["win_noop"] | hole

    def _leader_propose(self, s, c):
        super()._leader_propose(s, c)
        s["win_noop"] = s["win_noop"] & ~c.m_new

    # ------------------------------------------------------- write barrier
    def _commit_cap(self, s, c, peer_f):
        # per-slot responder clause: every responder of bucket(value) must
        # have acked past the slot; the first slot failing it caps the
        # commit frontier
        R, W, K = self.R, self.W, self.config.num_key_buckets
        _, abs_w = range_cover(s["commit_bar"], s["commit_bar"] + W, W)
        bucket = torch.where(
            ~s["win_noop"], torch.remainder(s["win_val"], K), -1
        )  # no-ops skip
        resp_bits = torch.gather(
            s["conf_resp"], 2, torch.clamp(bucket, 0, K - 1).to(torch.int64)
        )
        resp_bits = torch.where(bucket >= 0, resp_bits, 0)  # [G, R, W]
        member = (
            (resp_bits[..., None] >> arange32(R, self.device)) & 1
        ) != 0  # [G, R, W, R_peer]
        acked = peer_f[..., None, :] > abs_w[..., None]
        resp_ok = ~(member & ~acked).any(dim=3)  # [G, R, W]
        slot_known = s["win_abs"] == abs_w
        in_rng = abs_w < s["next_slot"][..., None]
        fail = in_rng & ~(resp_ok & slot_known)
        return torch.where(fail, abs_w, INF).amin(dim=2)

    # ----------------------------------------------------- sends + leases
    def _extra_sends(self, s, c, out, oflags):
        cfg = self.config
        ns_mask = self._ns_mask

        # CONF: every tick (epoch tag + propagation)
        has_conf = (s["conf_bal"] > 0)[..., None] & ns_mask
        oflags = oflags | flag_bits(has_conf, CONF)
        out["cf_bal"] = torch.where(has_conf, s["conf_bal"][..., None], 0)
        out["cf_leader"] = torch.where(has_conf, s["conf_leader"][..., None],
                                       0)
        out["cf_resp"] = s["conf_resp"]

        # AN: per-tick liveness beacon
        oflags = oflags | flag_bits(ns_mask, AN)
        out["bw_noop"] = s["win_noop"]

        # GRANT: refresh config leases at the installed conf; while a conf
        # change is pending, stop refreshing and REVOKE instead
        s["grant_cnt"] = torch.where(
            c.conf_pending | (s["grant_cnt"] > 0), s["grant_cnt"],
            cfg.grant_interval,
        )
        fire = (
            ~c.conf_pending
            & (s["conf_bal"] > 0)
            & (s["grant_cnt"] == cfg.grant_interval)
        )
        do_grant = fire[..., None] & ns_mask
        oflags = oflags | flag_bits(do_grant, GRANT)
        out["gr_len"] = do_grant.to(torch.int32) * cfg.lease_len
        out["gr_bal"] = torch.where(do_grant, s["conf_bal"][..., None], 0)
        out["gr_abar"] = torch.where(do_grant, s["vote_bar"][..., None], 0)
        s["lease_out"] = torch.where(
            do_grant, cfg.lease_len + cfg.lease_margin, s["lease_out"]
        )

        do_rv = c.conf_pending[..., None] & (s["lease_out"] > 0) & ns_mask
        oflags = oflags | flag_bits(do_rv, REVOKE)
        out["rv_bal"] = torch.where(do_rv, s["conf_bal"][..., None], 0)
        do_rvr = c.rv_reply & ns_mask
        oflags = oflags | flag_bits(do_rvr, REVOKE_REPLY)
        out["rvr_bal"] = torch.where(do_rvr, c.rv_echo, 0)
        return oflags

    # ------------------------------------------------------------- effects
    def _effects_extra(self, s, c):
        K = self.config.num_key_buckets
        lease_ok = (
            (s["lease_in"] > 0)
            & (s["in_bal"] == s["conf_bal"][..., None])
            & ~self._eye
        )
        lease_cnt = lease_ok.sum(dim=2, dtype=torch.int32)
        majority_leased = (lease_cnt + 1) >= self.quorum
        quiet = s["commit_bar"] >= s["pam"]

        # per-bucket local-read service: responder membership + no pending
        # write on the bucket in the un-executed window tail
        member = ((s["conf_resp"] >> c.rid[..., None]) & 1) != 0  # [G, R, K]
        tail = (
            (s["win_bal"] > 0)
            & (s["win_abs"] >= s["exec_bar"][..., None])
            & (s["win_abs"]
               < torch.maximum(s["vote_bar"], s["next_slot"])[..., None])
            & ~s["win_noop"]
        )
        bucket = torch.remainder(s["win_val"], K)
        pend = (
            tail[..., None, :] & (bucket[..., None, :] == self._karange[:, None])
        ).any(dim=3)  # [G, R, K]
        can_serve = member & ~pend & (majority_leased & quiet)[..., None]
        local_buckets = torch.where(can_serve, self._kbits, 0).sum(
            dim=2, dtype=torch.int32)
        stable_leader = (
            c.active_leader
            & (s["conf_leader"] == c.rid)
            & majority_leased
            & quiet
        )
        return {
            "conf_bal": s["conf_bal"],
            "conf_leader": s["conf_leader"],
            "lease_cnt": lease_cnt,
            "stable_leader": stable_leader,
            "local_read_buckets": local_buckets,
            "n_local_buckets": can_serve.sum(dim=2, dtype=torch.int32),
        }
