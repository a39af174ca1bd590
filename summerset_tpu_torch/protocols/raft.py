"""Vectorized Raft stepped in lockstep, counterpart of
``summerset_tpu/protocols/raft.py`` (see its module doc for the protocol
design: per-peer go-back-N AppendEntries range streams certified by the
prev-log check, one-shot conflict rewind hints, randomized elections with
the up-to-date vote check, the commit-only-current-term rule, and
install-snapshot jumps for followers behind the ring window).

The same 12 phases run in the same order over the same ``[G, R, ...]``
int32 state; the uint32 lanes (``flags``, ``grants``) are int32 with the
same bits.  CRaft subclasses the append / commit / exec hooks.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Tuple

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
    flag_bits,
    kth_largest,
    not_self,
    range_cover,
    take_lane,
    take_src,
)

# message flag bits
AE = 1            # AppendEntries (empty range = heartbeat)
AE_REPLY = 2
AR_NACK = 4       # modifier on AE_REPLY: prev-check failed; rewind to hint
REQVOTE = 8
VOTE_REPLY = 16
VOTE_GRANT = 32   # modifier on VOTE_REPLY
SNAPSHOT = 64     # install-snapshot: jump a >window-behind follower forward
# bits 128+ are reserved for subclass extensions


@dataclasses.dataclass
class ReplicaConfigRaft:
    """Static per-run knobs, the same fields and defaults as the JAX
    ``ReplicaConfigRaft``."""

    max_proposals_per_tick: int = 16
    chunk_size: int = 64
    hb_send_interval: int = 1
    hear_timeout_lo: int = 30
    hear_timeout_hi: int = 60
    retry_interval: int = 8
    dur_lag: int = 0
    exec_follows_commit: bool = True
    init_leader: int = 0                # warm-start leader id; -1 = cold elect
    tally: str = "pairwise"


def _gather_slot(win_abs, win_field, slot):
    """Look up ``slot`` in a ring window: ``[..., W]`` at ``[...]`` int32.
    Returns ``(ok, value)``: ok = the window holds that absolute slot
    (negative slots never match)."""
    W = win_abs.shape[-1]
    pos = torch.remainder(slot, W).to(torch.int64)[..., None]
    a = torch.gather(win_abs, -1, pos)[..., 0]
    v = torch.gather(win_field, -1, pos)[..., 0]
    return (a == slot) & (slot >= 0), v


@register_protocol("Raft")
class RaftKernel(ProtocolKernel):
    broadcast_lanes = frozenset({"bw_abs", "bw_term", "bw_val"})
    TALLY_LANES: Tuple[str, ...] = ("ar_term", "ar_f", "ar_hint", "ar_ebar")

    DURABLE_SCALARS = ("term", "voted_for", "log_end", "last_term")
    DURABLE_WINDOWS = ("win_abs", "win_term", "win_val")
    EXTRA_INPUTS: Tuple[Tuple[str, str], ...] = (("demote", "gr"),)

    def restore_durable(self, st, g, me, rec, floor):
        """Reinstate our row from the last logged term/vote metadata and
        log tail; the bars resume from the applier's floor.

        A row recovered into a term above the warm-start term comes back
        a follower with no known leader: the boot state's leader flag
        belongs to the warm-start term, and a replica must not lead a
        term it did not win (the JAX kernel keeps the flag; ROADMAP,
        Queue 3)."""
        fl = int(floor)
        log_end = max(int(rec["log_end"]), fl)
        st["term"] = _max_row(st["term"], g, me, int(rec["term"]))
        warm_term = 1 if self.config.init_leader >= 0 else 0
        if int(st["term"][g, me]) > warm_term:
            st["is_leader"] = _set_row(st["is_leader"], g, me, False)
            st["leader"] = _set_row(st["leader"], g, me, -1)
        st["voted_for"] = _set_row(st["voted_for"], g, me,
                                   int(rec["voted_for"]))
        st["log_end"] = _set_row(st["log_end"], g, me, log_end)
        st["last_term"] = _set_row(st["last_term"], g, me,
                                   int(rec["last_term"]))
        st["match_bar"] = _set_row(st["match_bar"], g, me, fl)
        st["dur_bar"] = _set_row(st["dur_bar"], g, me, log_end)
        st["commit_bar"] = _max_row(st["commit_bar"], g, me, fl)
        st["exec_bar"] = _max_row(st["exec_bar"], g, me, fl)
        for k in self.DURABLE_WINDOWS:
            st[k] = _set_row(
                st[k], g, me,
                torch.as_tensor(rec[k], dtype=st[k].dtype,
                                device=st[k].device),
            )

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 64,
        config: ReplicaConfigRaft | None = None,
        device=None,
    ):
        super().__init__(num_groups, population, window, device)
        self.config = config or ReplicaConfigRaft()
        quorum_lib.check_tally(getattr(self.config, "tally", "pairwise"))
        if self.collective_tally:
            self.broadcast_lanes = (
                frozenset(type(self).broadcast_lanes) | self.tally_lanes
            )
        if self.config.max_proposals_per_tick > window // 2:
            raise ValueError("max_proposals_per_tick must be <= window/2")
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
    def _extra_state(self, st: dict, seed: int) -> None:
        """Subclass state fields (added in place)."""

    def _extra_outbox(self, out: dict) -> None:
        """Subclass outbox fields (added in place)."""

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int = 0):
        G, R, W = self.G, self.R, self.W
        cfg = self.config
        zeros = self.zeros

        rng = prng.seed_state(seed, (G, R), device=self.device)
        rng, hb_cnt = prng.uniform_int(
            rng, cfg.hear_timeout_lo, cfg.hear_timeout_hi
        )

        st = {
            "term": zeros(G, R),
            "voted_for": self.full((G, R), -1),
            "cand_term": self.full((G, R), -1),
            "grants": zeros(G, R),
            "is_leader": zeros(G, R, dtype=torch.bool),
            "leader": self.full((G, R), -1),
            "own_from": zeros(G, R),
            "log_end": zeros(G, R),
            "last_term": zeros(G, R),
            "match_bar": zeros(G, R),
            "commit_bar": zeros(G, R),
            "exec_bar": zeros(G, R),
            "dur_bar": zeros(G, R),
            "hb_cnt": hb_cnt,
            "hb_send_cnt": zeros(G, R),
            "rng": rng,
            "next_idx": zeros(G, R, R),
            "match_f": zeros(G, R, R),
            "retry_cnt": self.full((G, R, R), cfg.retry_interval),
            "peer_exec": zeros(G, R, R),
            "win_abs": self.full((G, R, W), NO_SLOT),
            "win_term": zeros(G, R, W),
            "win_val": self.full((G, R, W), NULL_VAL),
        }

        if cfg.init_leader >= 0:
            L = cfg.init_leader
            st["term"] = self.full((G, R), 1)
            st["voted_for"] = self.full((G, R), L)
            st["is_leader"] = self._rid == L
            st["leader"] = self.full((G, R), L)
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
            "ae_term": pair(), "ae_lo": pair(), "ae_hi": pair(),
            "ae_prev": pair(), "ae_cbar": pair(),
            "ar_term": tlane(), "ar_f": tlane(), "ar_hint": tlane(),
            "ar_ebar": tlane(),
            "rv_term": pair(), "rv_lidx": pair(), "rv_lterm": pair(),
            "vr_term": pair(),
            "snp_term": pair(), "snp_to": pair(), "snp_lterm": pair(),
            "bw_abs": self.zeros(G, Rr, W),
            "bw_term": self.zeros(G, Rr, W),
            "bw_val": self.zeros(G, Rr, W),
        }
        self._extra_outbox(out)
        return out

    # ------------------------------------------------------------------ step
    PHASES: Tuple[Tuple[str, str], ...] = (
        ("ingest_reqvote", "_ingest_reqvote"),
        ("ingest_vote_reply", "_ingest_vote_reply"),
        ("ingest_ae", "_ingest_ae"),
        ("ingest_snapshot", "_ingest_snapshot"),
        ("ingest_ae_reply", "_ingest_ae_reply"),
        ("election", "_election"),
        ("try_win", "_try_win"),
        ("leader_append", "_leader_append"),
        (quorum_lib.PHASE_TALLY, "_phase_quorum_tally"),
        ("advance_bars", "_advance_bars"),
        ("telemetry", "_phase_telemetry"),
        ("build_outbox", "_phase_build_outbox"),
    )

    def step(self, state, inbox, inputs) -> Tuple[Any, Any, StepEffects]:
        s = dict(state)
        c = SimpleNamespace(
            inbox=inbox, inputs=inputs, flags=inbox["flags"], old=state
        )
        c.rid = self._rid
        # the election-timer reload is drawn every tick before any phase
        s["rng"], c.reload = prng.uniform_int(
            s["rng"], self.config.hear_timeout_lo, self.config.hear_timeout_hi
        )
        self._run_phases(s, c)
        fx = self._effects(s, c)
        return s, c.out, fx

    # ========== 1. REQVOTE ingest (vote granting; may bump term)
    def _ingest_reqvote(self, s, c):
        inbox = c.inbox
        rv_ok, rv_term, rv_src = best_by_ballot(
            c.flags, REQVOTE, inbox["rv_term"]
        )
        higher = rv_ok & (rv_term > s["term"])
        s["voted_for"] = torch.where(higher, -1, s["voted_for"])
        s["is_leader"] = s["is_leader"] & ~higher
        s["cand_term"] = torch.where(higher, -1, s["cand_term"])
        s["term"] = torch.where(higher, rv_term, s["term"])
        # any term change invalidates the per-(leader, term) certification
        # behind match_bar; commit_bar is the safe floor
        s["match_bar"] = torch.where(higher, s["commit_bar"], s["match_bar"])
        rv_lidx = take_src(inbox["rv_lidx"], rv_src)
        rv_lterm = take_src(inbox["rv_lterm"], rv_src)
        uptodate = (rv_lterm > s["last_term"]) | (
            (rv_lterm == s["last_term"]) & (rv_lidx >= s["log_end"])
        )
        can_vote = (
            rv_ok
            & (rv_term == s["term"])
            & ((s["voted_for"] < 0) | (s["voted_for"] == rv_src))
            & uptodate
            & ~s["is_leader"]
        )
        s["voted_for"] = torch.where(can_vote, rv_src, s["voted_for"])
        s["hb_cnt"] = torch.where(can_vote, c.reload, s["hb_cnt"])
        c.rv_ok, c.rv_src, c.can_vote = rv_ok, rv_src, can_vote

    # ========== 2. VOTE_REPLY ingest (candidate tally)
    def _ingest_vote_reply(self, s, c):
        vr_valid = (c.flags & VOTE_REPLY) != 0
        vr_grant = (
            vr_valid
            & ((c.flags & VOTE_GRANT) != 0)
            & (c.inbox["vr_term"] == s["term"][..., None])
        )
        s["grants"] = s["grants"] | torch.where(
            vr_grant, self._src_bits[None, None, :], 0
        ).sum(dim=2, dtype=torch.int32)
        c.vr_valid = vr_valid

    def _on_ae_write(self, s, c, m_acc, a_src):
        """Hook: extra per-slot lanes copied on an applied AE range."""

    # ========== 3. AE ingest (prev-check, entry write, commit notice)
    def _ingest_ae(self, s, c):
        W = self.W
        inbox = c.inbox
        a_ok, a_term, a_src = best_by_ballot(c.flags, AE, inbox["ae_term"])
        a_ok = a_ok & (a_term >= s["term"])
        # a leader never yields to an equal-term AE; a candidate at the
        # same term steps down to the winner
        a_ok = a_ok & ((a_term > s["term"]) | ~s["is_leader"])
        newterm = a_ok & (a_term > s["term"])
        s["voted_for"] = torch.where(newterm, -1, s["voted_for"])
        s["term"] = torch.where(a_ok, a_term, s["term"])
        # the certified-match frontier resets to the committed prefix
        # whenever the (leader, term) authority changes
        s["match_bar"] = torch.where(
            a_ok & (newterm | (s["leader"] != a_src)),
            s["commit_bar"],
            s["match_bar"],
        )
        s["is_leader"] = s["is_leader"] & ~a_ok
        s["cand_term"] = torch.where(a_ok, -1, s["cand_term"])
        s["leader"] = torch.where(a_ok, a_src, s["leader"])
        s["hb_cnt"] = torch.where(a_ok, c.reload, s["hb_cnt"])
        c.ae_ok = a_ok

        a_lo = take_src(inbox["ae_lo"], a_src)
        a_hi = take_src(inbox["ae_hi"], a_src)
        a_prev = take_src(inbox["ae_prev"], a_src)
        a_cbar = take_src(inbox["ae_cbar"], a_src)

        prev_in_win, own_pterm = _gather_slot(
            s["win_abs"], s["win_term"], a_lo - 1
        )
        prev_ok = (a_lo <= s["commit_bar"]) | (
            prev_in_win & (own_pterm == a_prev) & (a_lo - 1 < s["log_end"])
        )
        gap = a_ok & (a_lo > s["log_end"])
        acc = a_ok & ~gap & prev_ok
        rej = a_ok & ~gap & ~prev_ok
        c.nack = gap | rej
        # conflict backtrack hint: log_end past the end, else commit_bar
        c.nack_hint = torch.where(gap, s["log_end"], s["commit_bar"])

        m_acc, abs_acc = range_cover(a_lo, a_hi, W)
        m_acc = m_acc & acc[..., None]
        lane_term = take_lane(inbox["bw_term"], a_src)
        lane_val = take_lane(inbox["bw_val"], a_src)
        conflict = (
            m_acc
            & (s["win_abs"] == abs_acc)
            & (s["win_term"] != lane_term)
            & (abs_acc < s["log_end"][..., None])
        )
        any_conflict = conflict.any(dim=2)
        s["win_abs"] = torch.where(m_acc, abs_acc, s["win_abs"])
        s["win_term"] = torch.where(m_acc, lane_term, s["win_term"])
        s["win_val"] = torch.where(m_acc, lane_val, s["win_val"])
        self._on_ae_write(s, c, m_acc, a_src)
        # truncation rule: a conflict truncates to the written range's end
        s["log_end"] = torch.where(
            acc,
            torch.where(any_conflict, a_hi, torch.maximum(s["log_end"], a_hi)),
            s["log_end"],
        )
        s["dur_bar"] = torch.minimum(s["dur_bar"], s["log_end"])
        s["match_bar"] = torch.where(
            acc, torch.maximum(s["match_bar"], a_hi), s["match_bar"]
        )
        s["commit_bar"] = torch.where(
            acc,
            torch.maximum(s["commit_bar"],
                          torch.minimum(a_cbar, s["match_bar"])),
            s["commit_bar"],
        )
        lt_ok, lt_term = _gather_slot(
            s["win_abs"], s["win_term"], s["log_end"] - 1
        )
        s["last_term"] = torch.where(
            acc,
            torch.where(
                s["log_end"] > 0,
                torch.where(lt_ok, lt_term, s["last_term"]),
                0,
            ),
            s["last_term"],
        )
        c.a_ok, c.a_src, c.a_acc = a_ok, a_src, acc

    # ========== 3b. SNAPSHOT ingest (install: jump forward)
    def _ingest_snapshot(self, s, c):
        inbox = c.inbox
        sn_ok, sn_term, sn_src = best_by_ballot(
            c.flags, SNAPSHOT, inbox["snp_term"]
        )
        sn_ok = sn_ok & (sn_term >= s["term"])
        sn_ok = sn_ok & ((sn_term > s["term"]) | ~s["is_leader"])
        sn_to = take_src(inbox["snp_to"], sn_src)
        sn_lterm = take_src(inbox["snp_lterm"], sn_src)
        sn_new = sn_ok & (sn_term > s["term"])
        s["voted_for"] = torch.where(sn_new, -1, s["voted_for"])
        # an authority change without install still invalidates match_bar
        s["match_bar"] = torch.where(
            sn_ok & (sn_new | (s["leader"] != sn_src)),
            s["commit_bar"],
            s["match_bar"],
        )
        s["term"] = torch.where(sn_ok, sn_term, s["term"])
        s["is_leader"] = s["is_leader"] & ~sn_ok
        s["cand_term"] = torch.where(sn_ok, -1, s["cand_term"])
        s["leader"] = torch.where(sn_ok, sn_src, s["leader"])
        s["hb_cnt"] = torch.where(sn_ok, c.reload, s["hb_cnt"])
        sn_adv = sn_ok & (sn_to > s["commit_bar"])
        s["commit_bar"] = torch.where(sn_adv, sn_to, s["commit_bar"])
        s["exec_bar"] = torch.where(
            sn_adv, torch.maximum(s["exec_bar"], sn_to), s["exec_bar"]
        )
        s["log_end"] = torch.where(
            sn_adv, torch.maximum(s["log_end"], sn_to), s["log_end"]
        )
        s["match_bar"] = torch.where(sn_adv, sn_to, s["match_bar"])
        s["dur_bar"] = torch.where(
            sn_adv, torch.maximum(s["dur_bar"], sn_to), s["dur_bar"]
        )
        s["last_term"] = torch.where(
            sn_adv & (s["log_end"] == sn_to), sn_lterm, s["last_term"]
        )
        stale_win = sn_adv[..., None] & (s["win_abs"] < sn_to[..., None])
        s["win_abs"] = torch.where(stale_win, NO_SLOT, s["win_abs"])
        s["win_term"] = torch.where(stale_win, 0, s["win_term"])
        c.sn_ok, c.sn_adv, c.sn_to = sn_ok, sn_adv, sn_to

    # ========== 4. AE_REPLY ingest (leader match bookkeeping + step-down)
    def _ingest_ae_reply(self, s, c):
        cfg = self.config
        inbox = c.inbox
        ar = quorum_lib.pair_views(
            c.inbox, self.TALLY_LANES, self.collective_tally
        )
        ar_valid = (c.flags & AE_REPLY) != 0
        ar_mine = (
            ar_valid
            & (ar["ar_term"] == s["term"][..., None])
            & s["is_leader"][..., None]
        )
        prog = ar_mine & (ar["ar_f"] > s["match_f"])
        s["match_f"] = torch.where(
            ar_mine, torch.maximum(s["match_f"], ar["ar_f"]), s["match_f"]
        )
        ar_nacked = ar_mine & ((c.flags & AR_NACK) != 0)
        s["next_idx"] = torch.where(
            ar_nacked,
            torch.minimum(s["next_idx"], ar["ar_hint"]),
            s["next_idx"],
        )
        s["retry_cnt"] = torch.where(
            prog | ar_nacked, cfg.retry_interval, s["retry_cnt"]
        )
        s["peer_exec"] = torch.where(
            ar_valid,
            torch.maximum(s["peer_exec"], ar["ar_ebar"]),
            s["peer_exec"],
        )
        c.ar_valid, c.ar_mine = ar_valid, ar_mine

        # higher terms piggybacked on replies force step-down
        reply_tmax = torch.maximum(
            torch.where(c.vr_valid, inbox["vr_term"], 0).amax(dim=2),
            torch.where(ar_valid, ar["ar_term"], 0).amax(dim=2),
        )
        stepdown = reply_tmax > s["term"]
        s["term"] = torch.where(stepdown, reply_tmax, s["term"])
        s["voted_for"] = torch.where(stepdown, -1, s["voted_for"])
        s["is_leader"] = s["is_leader"] & ~stepdown
        s["cand_term"] = torch.where(stepdown, -1, s["cand_term"])
        s["match_bar"] = torch.where(stepdown, s["commit_bar"],
                                     s["match_bar"])

    def _apply_demote(self, s, c):
        """Voluntary step-down for rows flagged in the host ``demote``
        input: revert to follower, abandon any candidacy, and hold off
        re-campaigning for ``8 * hear_timeout_hi`` ticks."""
        dem = c.inputs.get("demote")
        if dem is None:
            return
        d = dem.to(torch.bool)
        holdoff = 8 * self.config.hear_timeout_hi
        s["is_leader"] = s["is_leader"] & ~d
        s["cand_term"] = torch.where(d, -1, s["cand_term"])
        s["leader"] = torch.where(d & (s["leader"] == c.rid), -1, s["leader"])
        s["hb_cnt"] = torch.where(d, holdoff, s["hb_cnt"])

    # ========== 5. election timeout -> campaign
    def _election(self, s, c):
        W = self.W
        rid = c.rid
        self._apply_demote(s, c)
        s["hb_cnt"] = torch.where(s["is_leader"], s["hb_cnt"],
                                  s["hb_cnt"] - 1)
        # a replica whose log tail fills its ring window could never append
        # the current-term entry the commit rule needs: it skips candidacy
        viable = s["log_end"] - s["exec_bar"] < W
        timer_out = ~s["is_leader"] & (s["hb_cnt"] <= 0)
        explode = timer_out & viable
        s["term"] = torch.where(explode, s["term"] + 1, s["term"])
        s["match_bar"] = torch.where(explode, s["commit_bar"],
                                     s["match_bar"])
        s["voted_for"] = torch.where(explode, rid, s["voted_for"])
        s["cand_term"] = torch.where(explode, s["term"], s["cand_term"])
        s["grants"] = torch.where(
            explode, torch.bitwise_left_shift(torch.ones_like(rid), rid),
            s["grants"],
        )
        s["leader"] = torch.where(explode, -1, s["leader"])
        s["rng"], reload2 = prng.uniform_int(
            s["rng"], self.config.hear_timeout_lo, self.config.hear_timeout_hi
        )
        s["hb_cnt"] = torch.where(timer_out, reload2, s["hb_cnt"])
        c.candidate = ~s["is_leader"] & (s["cand_term"] == s["term"])

    # ========== 6. candidate -> leader on vote quorum
    def _try_win(self, s, c):
        cfg = self.config
        win = c.candidate & (popcount(s["grants"]) >= self.quorum)
        s["is_leader"] = s["is_leader"] | win
        s["leader"] = torch.where(win, c.rid, s["leader"])
        s["own_from"] = torch.where(win, s["log_end"], s["own_from"])
        s["match_bar"] = torch.where(win, s["log_end"], s["match_bar"])
        s["next_idx"] = torch.where(
            win[..., None], s["log_end"][..., None], s["next_idx"]
        )
        s["match_f"] = torch.where(win[..., None], 0, s["match_f"])
        s["retry_cnt"] = torch.where(
            win[..., None], cfg.retry_interval, s["retry_cnt"]
        )
        s["hb_send_cnt"] = torch.where(win, 0, s["hb_send_cnt"])
        c.candidate = c.candidate & ~win
        c.win = win

    def _append_mode(self, s, c):
        """Hook: per-slot replication mode stamp for new appends (CRaft)."""
        return None

    def _on_append(self, s, c, m_new, mode):
        """Hook: extra per-slot lanes written on leader appends."""

    # ========== 7. leader appends: term no-op, then client proposals
    def _leader_append(self, s, c):
        W = self.W
        cfg = self.config
        lead = s["is_leader"]
        space = torch.clamp(s["exec_bar"] + W - s["log_end"], min=0)
        mode = self._append_mode(s, c)
        # a fresh leader with an uncommitted predecessor tail appends one
        # current-term no-op so the commit rule can fire without load
        need_noop = (
            lead
            & (s["log_end"] == s["own_from"])
            & (s["commit_bar"] < s["log_end"])
            & (space > 0)
        )
        n_noop = need_noop.to(torch.int32)
        m_np, abs_np = range_cover(s["log_end"], s["log_end"] + n_noop, W)
        s["win_abs"] = torch.where(m_np, abs_np, s["win_abs"])
        s["win_term"] = torch.where(m_np, s["term"][..., None],
                                    s["win_term"])
        s["win_val"] = torch.where(m_np, NULL_VAL, s["win_val"])
        self._on_append(s, c, m_np, mode)
        s["log_end"] = s["log_end"] + n_noop
        s["last_term"] = torch.where(need_noop, s["term"], s["last_term"])
        n_new, m_new, abs_new, new_vals = client_intake(
            s, c.inputs, lead, cfg.max_proposals_per_tick, W,
            frontier="log_end",
        )
        s["win_abs"] = torch.where(m_new, abs_new, s["win_abs"])
        s["win_term"] = torch.where(m_new, s["term"][..., None],
                                    s["win_term"])
        s["win_val"] = torch.where(m_new, new_vals, s["win_val"])
        self._on_append(s, c, m_new, mode)
        s["log_end"] = s["log_end"] + n_new
        s["last_term"] = torch.where(n_new > 0, s["term"], s["last_term"])
        s["match_bar"] = torch.where(lead, s["log_end"], s["match_bar"])
        c.n_new = n_new

    def _commit_frontier(self, s, c, peer_f):
        """Hook: quorum-tally frontier from durably-acked match frontiers."""
        return kth_largest(peer_f, self.quorum)

    def _exec_gate(self, s, c):
        """Hook: exec-bar advance (CRaft gates on shard availability)."""
        s["exec_bar"] = advance_exec(
            s, c.inputs, self.config.exec_follows_commit
        )

    # ========== 8. quorum tally: durability + match-index reduction
    def _phase_quorum_tally(self, s, c):
        s["dur_bar"] = advance_durability(
            s, self.config.dur_lag, frontier="log_end"
        )
        c.eye = self._eye
        c.peer_f = torch.where(self._eye, s["dur_bar"][..., None],
                               s["match_f"])
        c.q_tally = self._commit_frontier(s, c, c.peer_f)

    # ========== 8b. commit/exec bar advance off the tallied frontier
    def _advance_bars(self, s, c):
        # commit-only-current-term: at least one own-term entry replicated
        q_f = c.q_tally
        can_commit = s["is_leader"] & (q_f > s["own_from"])
        s["commit_bar"] = torch.where(
            can_commit,
            torch.minimum(torch.maximum(q_f, s["commit_bar"]), s["log_end"]),
            s["commit_bar"],
        )
        self._exec_gate(s, c)

    def _extra_sends(self, s, c, out, oflags):
        """Hook: subclass message sends; returns updated oflags."""
        return oflags

    # ========== 9. build outbox
    def _build_outbox(self, s, c):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        cfg = self.config
        ns_mask = self._ns_mask
        lead = s["is_leader"]
        out = {}
        oflags = self.zeros(G, Rr, R)

        # AE streams: go-back-N with retry rewind
        stale = lead[..., None] & ns_mask & (s["next_idx"] > s["match_f"])
        s["retry_cnt"] = torch.where(
            stale, s["retry_cnt"] - 1, cfg.retry_interval
        )
        rewind = stale & (s["retry_cnt"] <= 0)
        s["next_idx"] = torch.where(rewind, s["match_f"], s["next_idx"])
        s["retry_cnt"] = torch.where(rewind, cfg.retry_interval,
                                     s["retry_cnt"])

        # peers fallen below the ring window get an install-snapshot jump
        too_behind = (
            lead[..., None]
            & ns_mask
            & (s["next_idx"] < (s["log_end"] - W)[..., None])
        )
        snap_lt_ok, snap_lterm = _gather_slot(
            s["win_abs"], s["win_term"], s["exec_bar"] - 1
        )
        oflags = oflags | flag_bits(too_behind, SNAPSHOT)
        out["snp_term"] = torch.where(too_behind, s["term"][..., None], 0)
        out["snp_to"] = torch.where(too_behind, s["exec_bar"][..., None], 0)
        out["snp_lterm"] = torch.where(
            too_behind,
            torch.where(snap_lt_ok, snap_lterm, s["last_term"])[..., None],
            0,
        )
        s["next_idx"] = torch.where(
            too_behind, s["exec_bar"][..., None], s["next_idx"]
        )

        # heartbeat cadence: empty AE when nothing to replicate
        s["hb_send_cnt"] = torch.where(
            lead, s["hb_send_cnt"] - 1, cfg.hb_send_interval
        )
        hb_fire = lead & (s["hb_send_cnt"] <= 0)
        s["hb_send_cnt"] = torch.where(
            hb_fire, cfg.hb_send_interval, s["hb_send_cnt"]
        )

        snd_lo = s["next_idx"]
        snd_hi = torch.minimum(s["log_end"][..., None], snd_lo + self._chunk)
        have_data = snd_hi > snd_lo
        do_ae = (
            lead[..., None]
            & ns_mask
            & (have_data | hb_fire[..., None])
            & ~too_behind
        )
        snd_hi = torch.maximum(snd_hi, snd_lo)  # empty heartbeat: hi == lo
        # prev_log_term at lo-1 from the own window, per peer
        prev_ok_l, prev_t = _gather_slot(
            s["win_abs"][:, :, None, :].expand(G, Rr, R, W),
            s["win_term"][:, :, None, :].expand(G, Rr, R, W),
            snd_lo - 1,
        )
        oflags = oflags | flag_bits(do_ae, AE)
        out["ae_term"] = torch.where(do_ae, s["term"][..., None], 0)
        out["ae_lo"] = torch.where(do_ae, snd_lo, 0)
        out["ae_hi"] = torch.where(do_ae, snd_hi, 0)
        out["ae_prev"] = torch.where(do_ae & prev_ok_l, prev_t, 0)
        out["ae_cbar"] = torch.where(do_ae, s["commit_bar"][..., None], 0)
        s["next_idx"] = torch.where(do_ae, snd_hi, s["next_idx"])

        # AE_REPLY: follower acks its durable certified frontier; flags
        # are per-link in both tally modes, only the records differ
        is_follower = (
            (s["leader"] >= 0) & (s["leader"] != c.rid) & ~s["is_leader"]
        )
        do_ar = is_follower[..., None] & dst_onehot(s["leader"], R) & ns_mask
        oflags = oflags | flag_bits(do_ar, AE_REPLY)
        do_nack = do_ar & c.nack[..., None]
        oflags = oflags | flag_bits(do_nack, AR_NACK)
        ack_f = torch.minimum(s["match_bar"], s["dur_bar"])
        if self.collective_tally:
            out["ar_term"] = quorum_lib.source_lane(is_follower, s["term"])
            out["ar_f"] = quorum_lib.source_lane(is_follower, ack_f)
            out["ar_ebar"] = quorum_lib.source_lane(is_follower,
                                                    s["exec_bar"])
            out["ar_hint"] = quorum_lib.source_lane(
                is_follower & c.nack, c.nack_hint
            )
        else:
            out["ar_term"] = torch.where(do_ar, s["term"][..., None], 0)
            out["ar_f"] = torch.where(do_ar, ack_f[..., None], 0)
            out["ar_ebar"] = torch.where(do_ar, s["exec_bar"][..., None], 0)
            out["ar_hint"] = torch.where(do_nack, c.nack_hint[..., None], 0)

        # REQVOTE: candidates campaign every tick (loss-tolerant)
        do_rv = c.candidate[..., None] & ns_mask
        oflags = oflags | flag_bits(do_rv, REQVOTE)
        out["rv_term"] = torch.where(do_rv, s["term"][..., None], 0)
        out["rv_lidx"] = torch.where(do_rv, s["log_end"][..., None], 0)
        out["rv_lterm"] = torch.where(do_rv, s["last_term"][..., None], 0)

        # VOTE_REPLY: to the candidate we just heard (grant bit if granted)
        do_vr = c.rv_ok[..., None] & dst_onehot(c.rv_src, R) & ns_mask
        oflags = oflags | flag_bits(do_vr, VOTE_REPLY)
        oflags = oflags | flag_bits(do_vr & c.can_vote[..., None],
                                    VOTE_GRANT)
        out["vr_term"] = torch.where(do_vr, s["term"][..., None], 0)

        # broadcast window lanes: log content for AE receivers
        out["bw_abs"] = s["win_abs"]
        out["bw_term"] = s["win_term"]
        out["bw_val"] = s["win_val"]
        out["flags"] = self._extra_sends(s, c, out, oflags)
        return out

    def _telemetry(self, old, s, c) -> dict:
        """A term raise with ``voted_for == self`` is a campaign this
        replica started; any other raise is a foreign term adoption."""
        tel = super()._telemetry(old, s, c)
        raised = s["term"] > old["term"]
        own = s["voted_for"] == c.rid
        tel["elections"] = raised & own
        tel["ballots_adopted"] = raised & ~own
        tel["heartbeats"] = c.ae_ok
        tel["proposals"] = c.n_new
        tel["win_occupancy_hw"] = self._occupancy_span(s, "log_end")
        return tel

    def _effects_extra(self, s, c) -> dict:
        """Hook: protocol-specific effects fields."""
        return {}

    def _effects(self, s, c):
        # conservative min-exec over the group (snap_bar GC rule)
        eye_max = torch.where(c.eye, I32_MAX, s["peer_exec"])
        snap_bar = torch.minimum(eye_max.amin(dim=2), s["exec_bar"])
        extra = {
            "n_accepted": c.n_new,
            "is_leader": s["is_leader"] & (s["leader"] == c.rid),
            "snap_bar": snap_bar,
        }
        extra.update(self._effects_extra(s, c))
        return StepEffects(
            commit_bar=s["commit_bar"], exec_bar=s["exec_bar"], extra=extra
        )
