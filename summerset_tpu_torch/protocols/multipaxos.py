"""Vectorized MultiPaxos stepped in lockstep, counterpart of
``summerset_tpu/protocols/multipaxos.py`` (see its module doc for the
protocol design: per-peer go-back-N accept streams with cumulative acks,
commit notices on heartbeats, jittered elections, bulk Prepare with
per-slot max-ballot adoption, install-snapshot for laggards).

The same 14 phases run in the same order over the same ``[G, R, ...]``
int32 state; the uint32 lanes (``flags``, ``prep_acks``) are int32 with
the same bits.  One difference in mechanism, none in result: the heavy
``[G, R, R_src, W]`` prepare-reply adoption runs behind a host-checked
gate (``_gated_prepare_reply``), which reads one bool off the device each
tick.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Tuple

import numpy as np
import torch

from ..core import quorum as quorum_lib
from ..core.protocol import ProtocolKernel, StepEffects, _max_row, _set_row
from ..ops import prng
from ..utils.bitmap import popcount
from . import register_protocol
from .common import (
    I32_MAX,
    NO_SLOT,
    NULL_VAL,
    advance_durability,
    advance_exec,
    arange32,
    best_by_ballot,
    client_intake,
    dst_onehot,
    first_argmax,
    flag_bits,
    initial_ballot,
    make_greater_ballot,
    not_self,
    range_cover,
    take_lane,
    take_src,
)

# message flag bits
ACCEPT = 1
ACCEPT_REPLY = 2
HEARTBEAT = 4
HB_REPLY = 8
PREPARE = 16
PREPARE_REPLY = 32
AR_NACK = 64
SNAPSHOT = 128
# bits 256+ are reserved for subclass extensions

#: a follower whose vote run has started above its commit bar for this
#: many ticks repeats the accept NACK its leader never acted on
#: (``MultiPaxosKernel.renack``, run by a serving replica)
STALL_RENACK_TICKS = 150


@dataclasses.dataclass
class ReplicaConfigMultiPaxos:
    """Static per-run knobs, the same fields and defaults as the JAX
    ``ReplicaConfigMultiPaxos``."""

    max_proposals_per_tick: int = 16
    chunk_size: int = 64
    hb_send_interval: int = 1
    hear_timeout_lo: int = 30
    hear_timeout_hi: int = 60
    retry_interval: int = 8
    dur_lag: int = 0
    exec_follows_commit: bool = True
    init_leader: int = 0
    leader_leases: bool = False
    leader_lease_len: int = 12
    # must exceed the max one-way network delay in ticks (enforced by the
    # engine whenever a lease plane is active)
    lease_margin: int = 3
    tally: str = "pairwise"


@register_protocol("MultiPaxos")
class MultiPaxosKernel(ProtocolKernel):
    broadcast_lanes = frozenset({"bw_abs", "bw_bal", "bw_val"})
    TALLY_LANES: Tuple[str, ...] = ("ar_bal", "ar_from", "ar_f", "ar_hint")

    DURABLE_SCALARS = ("bal_max", "vote_bal", "vote_from", "vote_bar")
    DURABLE_WINDOWS = ("win_abs", "win_bal", "win_val")
    EXTRA_INPUTS: Tuple[Tuple[str, str], ...] = (("demote", "gr"),)
    HOST_SYNCS: Tuple[Tuple[str, str], ...] = (
        ("ingest_prepare_reply",
         "_gated_prepare_reply reads one bool a tick to skip the "
         "[G, R, R_src, W] adoption when no candidate got a reply (the "
         "JAX kernel's lax.cond); a gate a CUDA graph can capture is "
         "ROADMAP's graph-capturable prepare-reply gate"),
    )

    def reset_rows(self, st, reset):
        """The device reset's rule for the rebuilt rows, ``restore_durable``'s
        with the rewound commit bar as the floor: a vote run that starts
        above it comes back empty there, so the leader's next accept is
        nacked and it resends from the floor (or installs a snapshot).
        (The JAX engine keeps the run, and under a saturating load such a
        row never commits again; ROADMAP, Queue 3.)"""
        floor = st["commit_bar"]
        above = reset & (st["vote_from"] > floor)
        for k in ("vote_from", "vote_bar", "dur_bar"):
            st[k] = torch.where(above, floor, st[k])
        return st

    def renack(self, frames, view, me, cbar, stall):
        """Repeat a lost accept NACK.  A follower that adopts a new run
        starting above its commit bar nacks once, with the commit bar as
        hint, and its leader resends from there; if that one NACK is lost
        (a superseded or dropped frame, a peer restarting), the leader
        counts the run as matched and never resends below it, and the
        follower never commits again in that group (the commit needs
        ``vote_from <= commit_bar``; both packages alike, ROADMAP Queue
        3).  After ``STALL_RENACK_TICKS`` ticks in that state, the
        follower's accept replies to its leader carry the NACK again.  No
        vote is dropped, and a run that heals in time is left alone."""
        lead = view("leader")[:, me]
        stuck = (view("vote_from")[:, me] > cbar) & (lead >= 0) & (lead != me)
        stall = np.where(stuck, stall + 1, 0)
        n = 0
        for g in np.nonzero(stall >= STALL_RENACK_TICKS)[0]:
            f = frames.get(int(lead[g]))
            if f is None or not int(f["flags"][g]) & ACCEPT_REPLY:
                continue
            for k in ("flags", "ar_hint"):
                if f[k].base is not None:
                    f[k] = f[k].copy()
            f["flags"][g] |= AR_NACK
            f["ar_hint"][g] = cbar[g]
            n += 1
        return stall, n

    def restore_durable(self, st, g, me, rec, floor):
        """Reinstate our acceptor row from the last logged record.

        The commit bar comes back at the applied floor.  A vote run that
        starts above it would never let this follower commit again at
        its leader's ballot (the commit rule needs ``vote_from <=
        commit_bar``, and the leader counts the run as matched, so it
        never resends below it).  So the run comes back empty at the
        floor: the leader's next accept then lands past ``vote_bar``
        and is nacked with the floor as hint, and the leader resends
        from there.  The votes stay in the window.  (A deliberate
        difference from the JAX kernel, which keeps the run and stalls
        such a follower for good.)"""
        fl = int(floor)
        vfrom = int(rec["vote_from"])
        vbar = max(int(rec["vote_bar"]), fl)
        if vfrom > fl:
            vfrom = vbar = fl
        st["bal_max"] = _max_row(st["bal_max"], g, me, int(rec["bal_max"]))
        st["vote_bal"] = _set_row(st["vote_bal"], g, me, int(rec["vote_bal"]))
        st["vote_from"] = _set_row(st["vote_from"], g, me, vfrom)
        st["vote_bar"] = _max_row(st["vote_bar"], g, me, vbar)
        st["dur_bar"] = _set_row(st["dur_bar"], g, me, vbar)
        st["commit_bar"] = _max_row(st["commit_bar"], g, me, fl)
        st["exec_bar"] = _max_row(st["exec_bar"], g, me, fl)
        for k in self.DURABLE_WINDOWS:
            st[k] = _set_row(
                st[k], g, me,
                torch.as_tensor(rec[k], dtype=st[k].dtype,
                                device=st[k].device),
            )
        # proposal cursor: resume after everything this replica ever voted
        abs_arr = torch.as_tensor(rec["win_abs"], dtype=torch.int32)
        bal_arr = torch.as_tensor(rec["win_bal"], dtype=torch.int32)
        filled = (bal_arr > 0) & (abs_arr >= 0)
        nslot = max(fl, int(torch.where(filled, abs_arr + 1, 0).max()))
        st["next_slot"] = _max_row(st["next_slot"], g, me, nslot)

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigMultiPaxos | None = None,
        device=None,
    ):
        super().__init__(num_groups, population, window, device)
        self.config = config or ReplicaConfigMultiPaxos()
        quorum_lib.check_tally(getattr(self.config, "tally", "pairwise"))
        if self.collective_tally:
            self.broadcast_lanes = (
                frozenset(type(self).broadcast_lanes) | self.tally_lanes
            )
        if self.config.max_proposals_per_tick > window // 2:
            raise ValueError("max_proposals_per_tick must be <= window/2")
        if getattr(self.config, "leader_leases", False) and (
            self.config.hear_timeout_lo <= self.config.leader_lease_len
        ):
            raise ValueError(
                "hear_timeout_lo must exceed leader_lease_len (a follower "
                "must outlive its own promise before campaigning)"
            )
        self._chunk = min(self.config.chunk_size, window)
        self._build_consts()

    def _build_consts(self) -> None:
        # per-kernel constants, built once on the device (rows: the
        # stepped replica rows, R: the peers)
        G, Rr, R, dev = self.G, self.rows, self.R, self.device
        self._rid = self.row_ids()[None, :].expand(G, Rr)
        self._ns_mask = not_self(G, R, dev, self.row0, Rr)
        self._eye = self.row_eye()
        self._src_bits = torch.bitwise_left_shift(
            torch.ones(R, dtype=torch.int32, device=dev), arange32(R, dev)
        )

    # ------------------------------------------------------- subclass hooks
    @property
    def commit_k(self) -> int:
        return self.quorum

    @property
    def prepare_k(self) -> int:
        return self.quorum

    def _extra_state(self, st: dict, seed: int) -> None:
        """Subclass state fields (added in place)."""

    def _extra_outbox(self, out: dict) -> None:
        """Subclass outbox fields (added in place)."""

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int = 0):
        G, R, W = self.G, self.R, self.W
        cfg = self.config
        zeros = self.zeros
        rid = self._rid

        rng = prng.seed_state(seed, (G, R), device=self.device)
        rng, hb_cnt = prng.uniform_int(
            rng, cfg.hear_timeout_lo, cfg.hear_timeout_hi
        )

        st = {
            "bal_max": zeros(G, R),
            "bal_prepared": zeros(G, R),
            "bal_prep_sent": zeros(G, R),
            "leader": self.full((G, R), -1),
            "prep_trigger": zeros(G, R),
            "prep_acks": zeros(G, R),
            "prep_hi": zeros(G, R),
            "next_slot": zeros(G, R),
            "commit_bar": zeros(G, R),
            "exec_bar": zeros(G, R),
            "vote_bal": zeros(G, R),
            "vote_from": zeros(G, R),
            "vote_bar": zeros(G, R),
            "dur_bar": zeros(G, R),
            "hb_cnt": hb_cnt,
            "hb_send_cnt": zeros(G, R),
            "rng": rng,
            "next_idx": zeros(G, R, R),
            "match_f": zeros(G, R, R),
            "match_from": zeros(G, R, R),
            "match_bal": zeros(G, R, R),
            "retry_cnt": self.full((G, R, R), cfg.retry_interval),
            "peer_exec": zeros(G, R, R),
            "win_abs": self.full((G, R, W), NO_SLOT),
            "win_bal": zeros(G, R, W),
            "win_val": self.full((G, R, W), NULL_VAL),
        }

        if getattr(cfg, "leader_leases", False):
            # ll_left starts full: a restarted replica cannot know whether
            # it promised vote refusal just before dying
            st["ll_left"] = self.full((G, R), cfg.leader_lease_len)
            st["ll_in"] = zeros(G, R, R)

        if cfg.init_leader >= 0:
            L = cfg.init_leader
            bal0 = initial_ballot(L)
            is_l = (rid == L).to(torch.int32)
            st["bal_max"] = self.full((G, R), bal0)
            st["bal_prepared"] = is_l * bal0
            st["bal_prep_sent"] = is_l * bal0
            st["leader"] = self.full((G, R), L)
            st["vote_bal"] = self.full((G, R), bal0)
        self._extra_state(st, seed)
        return st

    # ---------------------------------------------------------------- outbox
    def zero_outbox(self):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        pair = lambda: self.zeros(G, Rr, R)  # noqa: E731
        tlane = (
            (lambda: self.zeros(G, Rr)) if self.collective_tally else pair
        )
        out = {
            "flags": pair(),
            "acc_bal": pair(), "acc_lo": pair(), "acc_hi": pair(),
            "ar_bal": tlane(), "ar_from": tlane(), "ar_f": tlane(),
            "ar_hint": tlane(),
            "hb_bal": pair(), "hb_cbar": pair(), "hb_ebar": pair(),
            "hbr_ebar": pair(),
            "prp_bal": pair(), "prp_trigger": pair(),
            "prr_bal": pair(), "prr_hi": pair(),
            "snp_bal": pair(), "snp_to": pair(),
            "bw_abs": self.zeros(G, Rr, W),
            "bw_bal": self.zeros(G, Rr, W),
            "bw_val": self.zeros(G, Rr, W),
        }
        self._extra_outbox(out)
        return out

    # ------------------------------------------------------------------ step
    PHASES: Tuple[Tuple[str, str], ...] = (
        ("ingest_heartbeat", "_ingest_heartbeat"),
        ("ingest_prepare", "_ingest_prepare"),
        ("ingest_snapshot", "_ingest_snapshot"),
        ("ingest_accept", "_ingest_accept"),
        ("ingest_accept_reply", "_ingest_accept_reply"),
        ("ingest_hb_reply", "_ingest_hb_reply"),
        ("ingest_prepare_reply", "_gated_prepare_reply"),
        ("election", "_election"),
        ("try_step_up", "_try_step_up"),
        ("leader_propose", "_leader_propose"),
        (quorum_lib.PHASE_TALLY, "_phase_quorum_tally"),
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
        self._run_phases(s, c)
        fx = self._effects(s, c)
        return s, c.out, fx

    # ========== 1. HEARTBEAT ingest (leader liveness + commit notice)
    def _ingest_heartbeat(self, s, c):
        cfg = self.config
        inbox = c.inbox
        if getattr(cfg, "leader_leases", False):
            s["ll_left"] = torch.clamp(s["ll_left"] - 1, min=0)
            s["ll_in"] = torch.clamp(s["ll_in"] - 1, min=0)
        hb_ok, hb_bal, hb_src = best_by_ballot(
            c.flags, HEARTBEAT, inbox["hb_bal"]
        )
        hb_ok = hb_ok & (hb_bal >= s["bal_max"])
        s["leader"] = torch.where(hb_ok, hb_src, s["leader"])
        s["bal_max"] = torch.where(hb_ok, hb_bal, s["bal_max"])
        s["rng"], c.reload = prng.uniform_int(
            s["rng"], cfg.hear_timeout_lo, cfg.hear_timeout_hi
        )
        s["hb_cnt"] = torch.where(hb_ok, c.reload, s["hb_cnt"])
        # follower commit advance: only when voting at the leader's ballot
        # with a run reaching back to (at or below) our commit bar
        hb_cbar = take_src(inbox["hb_cbar"], hb_src)
        can_commit = (
            hb_ok
            & (s["vote_bal"] == hb_bal)
            & (s["vote_from"] <= s["commit_bar"])
        )
        s["commit_bar"] = torch.where(
            can_commit,
            torch.maximum(s["commit_bar"],
                          torch.minimum(hb_cbar, s["vote_bar"])),
            s["commit_bar"],
        )
        if getattr(cfg, "leader_leases", False):
            s["ll_left"] = torch.where(hb_ok, cfg.leader_lease_len,
                                       s["ll_left"])
        c.hb_ok, c.hb_bal, c.hb_src = hb_ok, hb_bal, hb_src
        c.hb_reply_to = hb_ok

    def _vote_gate(self, s, c, p_bal, p_src):
        """Hook: extra veto on granting a Prepare promise."""
        if not getattr(self.config, "leader_leases", False):
            return torch.ones((self.G, self.rows), dtype=torch.bool,
                              device=self.device)
        return (s["ll_left"] <= 0) | (p_src == s["leader"])

    # ========== 2. PREPARE ingest (promise + voted-window reply)
    def _ingest_prepare(self, s, c):
        p_ok, p_bal, p_src = best_by_ballot(
            c.flags, PREPARE, c.inbox["prp_bal"]
        )
        p_ok = p_ok & (p_bal >= s["bal_max"])
        p_ok = p_ok & self._vote_gate(s, c, p_bal, p_src)
        s["bal_max"] = torch.where(p_ok, p_bal, s["bal_max"])
        s["leader"] = torch.where(p_ok, p_src, s["leader"])
        s["hb_cnt"] = torch.where(p_ok, c.reload, s["hb_cnt"])
        c.voted_extent = torch.where(
            s["win_bal"] > 0, s["win_abs"] + 1, 0
        ).amax(dim=2)
        c.prr_hi_out = c.voted_extent
        c.p_ok, c.p_bal, c.p_src = p_ok, p_bal, p_src

    # ========== 2b. SNAPSHOT ingest (install: jump forward)
    def _ingest_snapshot(self, s, c):
        inbox = c.inbox
        sn_ok, sn_bal, sn_src = best_by_ballot(
            c.flags, SNAPSHOT, inbox["snp_bal"]
        )
        sn_ok = sn_ok & (sn_bal >= s["bal_max"])
        sn_to = take_src(inbox["snp_to"], sn_src)
        sn_adv = sn_ok & (sn_to > s["commit_bar"])
        s["bal_max"] = torch.where(sn_ok, sn_bal, s["bal_max"])
        s["leader"] = torch.where(sn_ok, sn_src, s["leader"])
        s["hb_cnt"] = torch.where(sn_ok, c.reload, s["hb_cnt"])
        s["commit_bar"] = torch.where(sn_adv, sn_to, s["commit_bar"])
        s["exec_bar"] = torch.where(
            sn_adv, torch.maximum(s["exec_bar"], sn_to), s["exec_bar"]
        )
        s["vote_bal"] = torch.where(sn_adv, sn_bal, s["vote_bal"])
        s["vote_from"] = torch.where(sn_adv, sn_to, s["vote_from"])
        s["vote_bar"] = torch.where(sn_adv, sn_to, s["vote_bar"])
        s["dur_bar"] = torch.where(sn_adv, sn_to, s["dur_bar"])
        # drop window entries below the install point (now host state)
        stale_win = sn_adv[..., None] & (s["win_abs"] < sn_to[..., None])
        s["win_abs"] = torch.where(stale_win, NO_SLOT, s["win_abs"])
        s["win_bal"] = torch.where(stale_win, 0, s["win_bal"])
        c.sn_ok, c.sn_adv, c.sn_to = sn_ok, sn_adv, sn_to

    # ========== 3. ACCEPT ingest (acceptor voting run)
    def _ingest_accept(self, s, c):
        W = self.W
        inbox = c.inbox
        a_ok, a_bal, a_src = best_by_ballot(c.flags, ACCEPT, inbox["acc_bal"])
        a_ok = a_ok & (a_bal >= s["bal_max"])
        a_lo = take_src(inbox["acc_lo"], a_src)
        a_hi = take_src(inbox["acc_hi"], a_src)
        s["bal_max"] = torch.where(a_ok, a_bal, s["bal_max"])
        s["leader"] = torch.where(a_ok, a_src, s["leader"])
        s["hb_cnt"] = torch.where(a_ok, c.reload, s["hb_cnt"])

        same_run = a_ok & (s["vote_bal"] == a_bal)
        # a range entirely below the current run RESETS the run to it
        run_reset = (a_ok & (s["vote_bal"] != a_bal)) | (
            same_run & (a_hi < s["vote_from"])
        )
        run_merge = (
            same_run
            & (a_lo <= s["vote_bar"])
            & (a_hi >= s["vote_from"])
            & ~run_reset
        )
        gap = same_run & (a_lo > s["vote_bar"]) & ~run_reset
        new_run = run_reset
        apply_rng = run_merge | new_run

        m_acc, abs_acc = range_cover(a_lo, a_hi, W)
        m_acc = m_acc & apply_rng[..., None]
        lane_val = take_lane(inbox["bw_val"], a_src)
        s["win_abs"] = torch.where(m_acc, abs_acc, s["win_abs"])
        s["win_bal"] = torch.where(m_acc, a_bal[..., None], s["win_bal"])
        s["win_val"] = torch.where(m_acc, lane_val, s["win_val"])
        self._on_accept_write(s, c, m_acc, a_src)

        s["vote_from"] = torch.where(
            new_run,
            a_lo,
            torch.where(
                run_merge, torch.minimum(s["vote_from"], a_lo),
                s["vote_from"],
            ),
        )
        s["vote_bar"] = torch.where(
            new_run,
            a_hi,
            torch.where(
                run_merge, torch.maximum(s["vote_bar"], a_hi), s["vote_bar"]
            ),
        )
        s["vote_bal"] = torch.where(a_ok & apply_rng, a_bal, s["vote_bal"])
        # a new run above our commit bar leaves a hole -> nack
        c.nack = gap | (new_run & (a_lo > s["commit_bar"]))
        c.nack_hint = torch.where(gap, s["vote_bar"], s["commit_bar"])
        c.a_ok, c.a_src, c.a_bal = a_ok, a_src, a_bal
        c.a_new_run, c.a_applied, c.m_acc = new_run, apply_rng, m_acc
        c.a_lo, c.a_hi = a_lo, a_hi

    # ========== 4. ACCEPT_REPLY ingest (leader match bookkeeping)
    def _ingest_accept_reply(self, s, c):
        cfg = self.config
        ar = quorum_lib.pair_views(
            c.inbox, self.TALLY_LANES, self.collective_tally
        )
        ar_valid = (c.flags & ACCEPT_REPLY) != 0
        i_am_leader = (s["bal_prepared"] == s["bal_max"]) & (
            s["bal_prepared"] > 0
        )
        ar_mine = (
            ar_valid
            & (ar["ar_bal"] == s["bal_max"][..., None])
            & i_am_leader[..., None]
        )
        prog = ar_mine & (ar["ar_f"] > s["match_f"])
        c.ar_prog = prog
        s["match_f"] = torch.where(
            ar_mine, torch.maximum(s["match_f"], ar["ar_f"]), s["match_f"]
        )
        s["match_from"] = torch.where(ar_mine, ar["ar_from"],
                                      s["match_from"])
        s["match_bal"] = torch.where(ar_mine, ar["ar_bal"], s["match_bal"])
        ar_nacked = ar_mine & ((c.flags & AR_NACK) != 0)
        s["next_idx"] = torch.where(
            ar_nacked,
            torch.minimum(s["next_idx"], ar["ar_hint"]),
            s["next_idx"],
        )
        s["retry_cnt"] = torch.where(
            prog | ar_nacked, cfg.retry_interval, s["retry_cnt"]
        )
        c.ar_mine = ar_mine

    # ========== 5. HB_REPLY ingest (peer exec bars for snap_bar GC)
    def _ingest_hb_reply(self, s, c):
        hbr_valid = (c.flags & HB_REPLY) != 0
        c.hbr_valid = hbr_valid
        if getattr(self.config, "leader_leases", False):
            s["ll_in"] = torch.where(
                hbr_valid,
                self.config.leader_lease_len - self.config.lease_margin,
                s["ll_in"],
            )
        s["peer_exec"] = torch.where(
            hbr_valid,
            torch.maximum(s["peer_exec"], c.inbox["hbr_ebar"]),
            s["peer_exec"],
        )

    def _candidate_mask(self, s):
        """[G, R] bool: replicas mid-campaign (prepare sent, not yet won)."""
        return (s["bal_prep_sent"] == s["bal_max"]) & (
            s["bal_prepared"] != s["bal_max"]
        )

    # -- prepare-reply gate --------------------------------------------------
    def _gated_prepare_reply(self, s, c):
        """Run ``_ingest_prepare_reply`` only when some candidate received a
        PREPARE_REPLY this tick.

        The adoption path materializes ``[G, R, R_src, W]`` tensors and is
        a provable no-op whenever ``pr_mine`` is all-false.  The JAX
        reference skips it with ``lax.cond``; here the host reads
        ``any_pr`` off the device, which costs one synchronisation per
        tick (a gate that a CUDA graph can capture is queued in ROADMAP).

        Contract: all effects of ``_ingest_prepare_reply`` land in ``s``;
        attributes it sets on ``c`` are discarded."""
        c.candidate = self._candidate_mask(s)
        any_pr = torch.any(
            ((c.flags & PREPARE_REPLY) != 0) & c.candidate[..., None]
        )
        if bool(any_pr):
            self._ingest_prepare_reply(s, SimpleNamespace(**vars(c)))

    # -- prepare-reply shared prologue (tally + voted-lane views) ------------
    def _prep_reply_common(self, s, c):
        W = self.W
        inbox = c.inbox
        candidate = self._candidate_mask(s)
        pr_valid = (c.flags & PREPARE_REPLY) != 0
        pr_mine = (
            pr_valid
            & (inbox["prr_bal"] == s["bal_prep_sent"][..., None])
            & candidate[..., None]
        )
        s["prep_acks"] = s["prep_acks"] | torch.where(
            pr_mine, self._src_bits[None, None, :], 0
        ).sum(dim=2, dtype=torch.int32)
        s["prep_hi"] = torch.maximum(
            s["prep_hi"],
            torch.where(pr_mine, inbox["prr_hi"], 0).amax(dim=2),
        )
        c.candidate = candidate
        c.pr_mine = pr_mine
        trig = s["prep_trigger"]
        _, abs_ad = range_cover(trig, trig + W, W)
        c.pr_abs_ad = abs_ad
        c.pr_lane_bal = inbox["bw_bal"][:, None, :, :]  # [G, 1, R_src, W]
        c.pr_lane_val = inbox["bw_val"][:, None, :, :]
        in_rng = abs_ad[:, :, None, :] < torch.minimum(
            inbox["prr_hi"], trig[..., None] + W
        )[..., None]
        c.pr_ok = (
            pr_mine[..., None]
            & (inbox["bw_abs"][:, None, :, :] == abs_ad[:, :, None, :])
            & (c.pr_lane_bal > 0)
            & in_rng
        )

    def _best_of_senders(self, c):
        """Per-slot max ballot over replying senders ``[G, R, W]``, the
        first sender holding it ``[G, R, 1, W]`` and its value."""
        eff_bal = torch.where(c.pr_ok, c.pr_lane_bal, 0)  # [G, R, R_src, W]
        best_bal = eff_bal.amax(dim=2)
        best_src = first_argmax(eff_bal, best_bal, 2)[:, :, None, :]
        best_val = torch.gather(
            c.pr_lane_val.expand(eff_bal.shape), 2, best_src.to(torch.int64)
        )[:, :, 0, :]
        return best_bal, best_src, best_val

    # ========== 6. PREPARE_REPLY ingest (candidate tally + adoption) [HOOK]
    def _ingest_prepare_reply(self, s, c):
        self._prep_reply_common(s, c)
        abs_ad = c.pr_abs_ad
        best_bal, best_src, best_val = self._best_of_senders(c)
        adopt = (best_bal > 0) & (
            (s["win_abs"] != abs_ad) | (best_bal > s["win_bal"])
        )
        s["win_abs"] = torch.where(adopt, abs_ad, s["win_abs"])
        s["win_bal"] = torch.where(adopt, best_bal, s["win_bal"])
        s["win_val"] = torch.where(adopt, best_val, s["win_val"])
        self._on_adopt(s, c, adopt, best_src)

    def _on_accept_write(self, s, c, m_acc, a_src):
        """Hook: extra per-slot lanes copied on an applied Accept range."""

    def _on_adopt(self, s, c, adopt, best_src):
        """Hook: extra per-slot lanes adopted from the best sender."""

    def _on_explode(self, s, c, explode):
        """Hook: candidate-side bookkeeping at campaign start."""

    def _campaign_gate(self, s, c):
        """Hook: extra veto on starting a campaign."""
        if not getattr(self.config, "leader_leases", False):
            return torch.ones((self.G, self.rows), dtype=torch.bool,
                              device=self.device)
        return s["ll_left"] <= 0

    def _apply_demote(self, s, c):
        """Voluntary step-down for rows flagged in the host ``demote``
        input: drop the prepared ballot and candidacy, then hold off
        re-campaigning for ``8 * hear_timeout_hi`` ticks."""
        dem = c.inputs.get("demote")
        if dem is None:
            return
        d = dem.to(torch.bool)
        holdoff = 8 * self.config.hear_timeout_hi
        s["bal_prepared"] = torch.where(d, 0, s["bal_prepared"])
        s["bal_prep_sent"] = torch.where(d, 0, s["bal_prep_sent"])
        s["leader"] = torch.where(d & (s["leader"] == c.rid), -1, s["leader"])
        s["hb_cnt"] = torch.where(d, holdoff, s["hb_cnt"])

    # ========== 7. election timeout -> campaign
    def _election(self, s, c):
        cfg = self.config
        W = self.W
        rid = c.rid
        self._apply_demote(s, c)
        i_am_leader = (s["bal_prepared"] == s["bal_max"]) & (
            s["bal_prepared"] > 0
        )
        active_leader = i_am_leader & (s["leader"] == rid)
        s["hb_cnt"] = torch.where(active_leader, s["hb_cnt"],
                                  s["hb_cnt"] - 1)
        # a voted tail more than a window past the commit bar cannot lead
        viable = c.voted_extent - s["commit_bar"] <= W
        explode = (
            (~active_leader)
            & (s["hb_cnt"] <= 0)
            & viable
            & self._campaign_gate(s, c)
        )
        timer_out = (~active_leader) & (s["hb_cnt"] <= 0)
        new_bal = make_greater_ballot(s["bal_max"], rid)
        s["bal_max"] = torch.where(explode, new_bal, s["bal_max"])
        s["bal_prep_sent"] = torch.where(explode, new_bal,
                                         s["bal_prep_sent"])
        s["prep_trigger"] = torch.where(
            explode, s["commit_bar"], s["prep_trigger"]
        )
        s["prep_acks"] = torch.where(
            explode, torch.bitwise_left_shift(torch.ones_like(rid), rid),
            s["prep_acks"],
        )
        s["prep_hi"] = torch.where(
            explode, torch.maximum(c.voted_extent, s["commit_bar"]),
            s["prep_hi"],
        )
        s["leader"] = torch.where(explode, rid, s["leader"])
        s["rng"], reload2 = prng.uniform_int(
            s["rng"], cfg.hear_timeout_lo, cfg.hear_timeout_hi
        )
        s["hb_cnt"] = torch.where(timer_out, reload2, s["hb_cnt"])
        self._on_explode(s, c, explode)
        c.candidate = (c.candidate | explode) & (
            s["bal_prep_sent"] == s["bal_max"]
        )

    def _win_condition(self, s, c):
        """Hook: promise tally -> step-up decision (``[G, R]`` bool)."""
        return c.candidate & (popcount(s["prep_acks"]) >= self.prepare_k)

    def _adopt_on_win(self, s, c, win, m_re, abs_re):
        """Hook: write the re-proposal window content for winners: keep
        adopted values, fill holes with no-ops, stamp the new ballot."""
        hole = m_re & (s["win_abs"] != abs_re)
        s["win_val"] = torch.where(hole, NULL_VAL, s["win_val"])
        s["win_abs"] = torch.where(m_re, abs_re, s["win_abs"])
        s["win_bal"] = torch.where(m_re, s["bal_max"][..., None],
                                   s["win_bal"])

    # ========== 8. candidate -> leader on prepare quorum
    def _try_step_up(self, s, c):
        W = self.W
        # a candidate whose window cannot hold the voted tail must yield
        behind = c.candidate & (s["prep_hi"] - s["prep_trigger"] > W)
        # and one that could not heal laggards from its window too
        behind = behind | (c.candidate & (
            torch.maximum(s["prep_hi"], s["commit_bar"]) - s["exec_bar"] > W
        ))
        s["bal_prep_sent"] = torch.where(behind, 0, s["bal_prep_sent"])
        c.candidate = c.candidate & ~behind
        win = self._win_condition(s, c)
        trig = s["prep_trigger"]
        nslot = torch.maximum(s["prep_hi"], s["commit_bar"])
        m_re, abs_re = range_cover(trig, nslot, W)
        m_re = m_re & win[..., None]
        self._adopt_on_win(s, c, win, m_re, abs_re)
        s["bal_prepared"] = torch.where(win, s["bal_max"], s["bal_prepared"])
        s["next_slot"] = torch.where(win, nslot, s["next_slot"])
        s["next_idx"] = torch.where(
            win[..., None], trig[..., None], s["next_idx"]
        )
        s["match_bal"] = torch.where(win[..., None], 0, s["match_bal"])
        s["match_f"] = torch.where(win[..., None], 0, s["match_f"])
        s["vote_bal"] = torch.where(win, s["bal_max"], s["vote_bal"])
        s["vote_from"] = torch.where(win, trig, s["vote_from"])
        s["vote_bar"] = torch.where(win, nslot, s["vote_bar"])
        s["hb_send_cnt"] = torch.where(win, 0, s["hb_send_cnt"])
        c.win = win

    # ========== 9. leader proposals (client batch intake)
    def _leader_propose(self, s, c):
        cfg = self.config
        W = self.W
        i_am_leader = (s["bal_prepared"] == s["bal_max"]) & (
            s["bal_prepared"] > 0
        )
        active_leader = i_am_leader & (s["leader"] == c.rid)
        n_new, m_new, abs_new, new_vals = client_intake(
            s, c.inputs, active_leader, cfg.max_proposals_per_tick, W
        )
        s["win_abs"] = torch.where(m_new, abs_new, s["win_abs"])
        s["win_bal"] = torch.where(m_new, s["bal_max"][..., None],
                                   s["win_bal"])
        s["win_val"] = torch.where(m_new, new_vals, s["win_val"])
        s["next_slot"] = s["next_slot"] + n_new
        s["vote_bar"] = torch.where(active_leader, s["next_slot"],
                                    s["vote_bar"])
        c.active_leader = active_leader
        c.n_new, c.m_new = n_new, m_new

    def _exec_gate(self, s, c):
        """Hook: exec-bar advance (RSPaxos gates it on shard availability)."""
        s["exec_bar"] = advance_exec(
            s, c.inputs, self.config.exec_follows_commit
        )

    def _peer_frontiers(self, s):
        """Per-peer ballot-matched acked frontiers [G, R, R_peer]; own
        column = own durable frontier."""
        peer_f = torch.where(
            (s["match_bal"] == s["bal_max"][..., None])
            & (s["match_from"] <= s["commit_bar"][..., None]),
            s["match_f"],
            0,
        )
        return torch.where(self._eye, s["dur_bar"][..., None], peer_f)

    # ========== 10. quorum tally: durability + the frontier reduction
    def _phase_quorum_tally(self, s, c):
        s["dur_bar"] = advance_durability(
            s, self.config.dur_lag, frontier="vote_bar"
        )
        c.peer_f = self._peer_frontiers(s)
        c.q_tally = self._tally_frontier(s, c, c.peer_f)

    def _tally_frontier(self, s, c, peer_f):
        """Hook: segmented reduction over acked frontiers -> [G, R]."""
        return quorum_lib.quorum_frontier(peer_f, self.commit_k)

    # ========== 10b. commit/exec bar advance off the tallied frontier
    def _advance_bars(self, s, c):
        q_f = torch.minimum(c.q_tally, self._commit_cap(s, c, c.peer_f))
        s["commit_bar"] = torch.where(
            c.active_leader,
            torch.minimum(torch.maximum(q_f, s["commit_bar"]),
                          s["next_slot"]),
            s["commit_bar"],
        )
        self._exec_gate(s, c)

    def _commit_cap(self, s, c, peer_f):
        """Hook: extra cap on the commit frontier."""
        return self.full((self.G, self.rows), I32_MAX)

    def _extra_sends(self, s, c, out, oflags):
        """Hook: subclass message sends; returns updated oflags."""
        return oflags

    # ========== 11. build outbox
    def _build_outbox(self, s, c):
        R, W = self.R, self.W
        cfg = self.config
        ns_mask = self._ns_mask
        active_leader = c.active_leader
        out = {}
        oflags = self.zeros(self.G, self.rows, R)

        # ACCEPT streams: per-peer go-back-N with retry rewind
        stale = (
            active_leader[..., None]
            & ns_mask
            & (
                s["next_idx"]
                > torch.maximum(s["match_f"], s["prep_trigger"][..., None])
            )
        )
        s["retry_cnt"] = torch.where(
            stale, s["retry_cnt"] - 1, cfg.retry_interval
        )
        rewind = stale & (s["retry_cnt"] <= 0)
        matched_ok = s["match_bal"] == s["bal_max"][..., None]
        s["next_idx"] = torch.where(
            rewind,
            torch.where(matched_ok, s["match_f"],
                        s["prep_trigger"][..., None]),
            s["next_idx"],
        )
        s["retry_cnt"] = torch.where(rewind, cfg.retry_interval,
                                     s["retry_cnt"])

        # peers fallen below the leader's window get an install-snapshot
        # jump to the leader's exec bar (which must itself be in-window)
        too_behind = (
            active_leader[..., None]
            & ns_mask
            & (s["next_idx"] < (s["next_slot"] - W)[..., None])
            & (s["exec_bar"] >= s["next_slot"] - W)[..., None]
        )
        oflags = oflags | flag_bits(too_behind, SNAPSHOT)
        out["snp_bal"] = torch.where(too_behind, s["bal_max"][..., None], 0)
        out["snp_to"] = torch.where(too_behind, s["exec_bar"][..., None], 0)
        s["next_idx"] = torch.where(
            too_behind, s["exec_bar"][..., None], s["next_idx"]
        )

        snd_lo = s["next_idx"]
        snd_hi = torch.minimum(s["next_slot"][..., None], snd_lo + self._chunk)
        do_acc = active_leader[..., None] & ns_mask & (snd_hi > snd_lo)
        oflags = oflags | flag_bits(do_acc, ACCEPT)
        out["acc_bal"] = torch.where(do_acc, s["bal_max"][..., None], 0)
        out["acc_lo"] = torch.where(do_acc, snd_lo, 0)
        out["acc_hi"] = torch.where(do_acc, snd_hi, 0)
        s["next_idx"] = torch.where(do_acc, snd_hi, s["next_idx"])

        # HEARTBEAT: leader every hb_send_interval ticks
        s["hb_send_cnt"] = torch.where(
            active_leader, s["hb_send_cnt"] - 1, cfg.hb_send_interval
        )
        hb_due = active_leader & (s["hb_send_cnt"] <= 0)
        do_hb = hb_due[..., None] & ns_mask
        s["hb_send_cnt"] = torch.where(
            hb_due, cfg.hb_send_interval, s["hb_send_cnt"]
        )
        oflags = oflags | flag_bits(do_hb, HEARTBEAT)
        out["hb_bal"] = torch.where(do_hb, s["bal_max"][..., None], 0)
        out["hb_cbar"] = torch.where(do_hb, s["commit_bar"][..., None], 0)
        out["hb_ebar"] = torch.where(do_hb, s["exec_bar"][..., None], 0)

        # HB_REPLY: to the heartbeat sender
        do_hbr = c.hb_reply_to[..., None] & dst_onehot(c.hb_src, R) & ns_mask
        oflags = oflags | flag_bits(do_hbr, HB_REPLY)
        out["hbr_ebar"] = torch.where(do_hbr, s["exec_bar"][..., None], 0)

        # ACCEPT_REPLY: follower acks its durable frontier to its leader;
        # flags are per-link in both tally modes, only the records differ
        is_follower = (
            (s["leader"] >= 0)
            & (s["leader"] != c.rid)
            & (s["vote_bal"] == s["bal_max"])
            & (s["vote_bal"] > 0)
        )
        do_ar = is_follower[..., None] & dst_onehot(s["leader"], R) & ns_mask
        oflags = oflags | flag_bits(do_ar, ACCEPT_REPLY)
        do_nack = do_ar & c.nack[..., None]
        oflags = oflags | flag_bits(do_nack, AR_NACK)
        if self.collective_tally:
            out["ar_bal"] = quorum_lib.source_lane(is_follower, s["vote_bal"])
            out["ar_from"] = quorum_lib.source_lane(
                is_follower, s["vote_from"]
            )
            out["ar_f"] = quorum_lib.source_lane(is_follower, s["dur_bar"])
            out["ar_hint"] = quorum_lib.source_lane(
                is_follower & c.nack, c.nack_hint
            )
        else:
            out["ar_bal"] = torch.where(do_ar, s["vote_bal"][..., None], 0)
            out["ar_from"] = torch.where(do_ar, s["vote_from"][..., None], 0)
            out["ar_f"] = torch.where(do_ar, s["dur_bar"][..., None], 0)
            out["ar_hint"] = torch.where(do_nack, c.nack_hint[..., None], 0)

        # PREPARE: candidates campaign every tick (loss-tolerant)
        do_prp = c.candidate[..., None] & ns_mask
        oflags = oflags | flag_bits(do_prp, PREPARE)
        out["prp_bal"] = torch.where(do_prp, s["bal_prep_sent"][..., None], 0)
        out["prp_trigger"] = torch.where(
            do_prp, s["prep_trigger"][..., None], 0
        )

        # PREPARE_REPLY: to the campaigner we just promised
        do_prr = c.p_ok[..., None] & dst_onehot(c.p_src, R) & ns_mask
        oflags = oflags | flag_bits(do_prr, PREPARE_REPLY)
        out["prr_bal"] = torch.where(do_prr, c.p_bal[..., None], 0)
        out["prr_hi"] = torch.where(do_prr, c.prr_hi_out[..., None], 0)

        # broadcast window lanes: voted log content
        out["bw_abs"] = s["win_abs"]
        out["bw_bal"] = s["win_bal"]
        out["bw_val"] = s["win_val"]
        out["flags"] = self._extra_sends(s, c, out, oflags)
        return out

    def _telemetry(self, old, s, c) -> dict:
        """Ballots are ``(round << 8) | id``: a bal_max raise whose low byte
        is the raiser's id is its own campaign, any other an adoption."""
        tel = super()._telemetry(old, s, c)
        raised = s["bal_max"] > old["bal_max"]
        own = (s["bal_max"] & 255) == c.rid
        tel["elections"] = raised & own
        tel["ballots_adopted"] = raised & ~own
        tel["heartbeats"] = c.hb_ok
        return tel

    def _effects_extra(self, s, c) -> dict:
        """Hook: protocol-specific effects fields."""
        return {}

    def _effects(self, s, c):
        # conservative min-exec over the group (the reference's snap_bar)
        eye_max = torch.where(self._eye, I32_MAX, s["peer_exec"])
        snap_bar = torch.minimum(eye_max.amin(dim=2), s["exec_bar"])
        extra = {
            "n_accepted": c.n_new,
            "is_leader": c.active_leader,
            "snap_bar": snap_bar,
        }
        if getattr(self.config, "leader_leases", False):
            ll_cnt = (s["ll_in"] > 0).sum(dim=2, dtype=torch.int32) + 1
            extra["leader_read_ok"] = c.active_leader & (
                ll_cnt >= self.quorum
            )
        extra.update(self._effects_extra(s, c))
        return StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"], extra=extra
        )
