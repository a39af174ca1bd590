"""Vectorized EPaxos: leaderless consensus over a 2-D instance space,
counterpart of ``summerset_tpu/protocols/epaxos.py`` (see its module doc
for the design: per-bucket interference tables instead of per-instance
reply payloads, cumulative accept frontiers, the device-only row-frontier
execution heuristic, and per-row failover through the ExpPrepare decision
ladder).

Both of the reference's stated limits are kept as they are: the device-only
execution heuristic may run chains that mix instance-level SCCs inside one
row-level cycle in seq order rather than topological order (the host
Tarjan executor, ``host/epaxos_exec.py``, is the authoritative path), and
the decision ladder is the original paper's recovery, whose optimized-
quorum corner is known to be unsound in theory.

Translation notes: the uint32 ``flags`` lane is int32 with the same bits;
the row closure's integer ``einsum`` is a broadcast AND with ``any`` over
the middle axis (integer matmul is not implemented on CUDA); every
``argmax`` goes through ``first_argmax``/``first_true`` so the first
maximum wins; every count pins int32; the bool lanes (``noop2``,
``pbump2`` and the ``*_noop``/``rv_bump`` lanes) stay bool.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Tuple

import torch

from ..core.protocol import ProtocolKernel, StepEffects, _set_row
from . import register_protocol
from .common import (
    INF,
    arange32,
    first_argmax,
    first_true,
    flag_bits,
    make_greater_ballot,
    range_cover,
)

# flag bits
BEACON = 1    # ow/tb/sb/rp_abar lanes valid (sent every tick)
ERP = 2       # explicit-prepare campaign for erp_row at erp_bal
RV = 4        # rv_* lanes carry my stored copy of rv_row (ERP response)
RO = 8        # ro_* lanes drive a recovered row at ro_bal

# status codes
NULL, PREACC, ACCEPTING, COMMITTED = 0, 1, 2, 3

I32 = torch.int32


def _pick(x, idx):
    """``x[g, r, idx[g, r]]`` along axis 2 (``take_along_axis``)."""
    return torch.gather(x, 2, idx[..., None].long())[..., 0]


def _sum32(mask, dim):
    return mask.sum(dim=dim, dtype=I32)


def _clip(x, lo, hi):
    """``jnp.clip`` with tensor bounds: ``min(max(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


@dataclasses.dataclass
class ReplicaConfigEPaxos:
    """The same fields and defaults as the JAX ``ReplicaConfigEPaxos``."""

    max_proposals_per_tick: int = 8   # per group, split across replicas
    num_key_buckets: int = 8          # conflict-detection key buckets
    optimized_quorum: bool = True     # super = N/2 + ceil((N/2)/2)
    alive_timeout: int = 30           # ticks silent -> peer considered dead
    stall_timeout: int = 40           # own-row wedge -> self-ERP heal
    exec_follows_commit: bool = True  # device-only exec heuristic on


@register_protocol("EPaxos")
class EPaxosKernel(ProtocolKernel):
    broadcast_lanes = frozenset({
        "ow_abs", "ow_phase", "ow_bal", "ow_seq", "ow_val", "ow_noop",
        "ow_deps", "tb_col", "tb_seq", "sb",
        "ro_row", "ro_bal", "ro_abs", "ro_phase", "ro_seq", "ro_val",
        "ro_noop", "ro_deps",
        "rv_row", "rv_bal", "rv_abs", "rv_st", "rv_vbal", "rv_seq",
        "rv_val", "rv_noop", "rv_deps", "rv_bump", "rv_cmt",
    })

    # durable acceptor record: the whole 2-D stored-copy space plus the
    # interference tables and the own-row cursor
    DURABLE_SCALARS = ("own_next",)
    DURABLE_WINDOWS = (
        "abs2", "st2", "bal2", "seq2", "val2", "noop2", "deps2", "pbump2",
        "it_col", "it_seq",
    )
    VALUE_WINDOW = "val2"

    # host-serving inputs: the proposing replica id, its minted vid list,
    # and the per-row exec floors from the host Tarjan executor
    EXTRA_INPUTS = (
        ("prop_replica", "g"),
        ("prop_vids", "gp"),
        ("exec_floor_rows", "grr"),
    )

    def restore_durable(self, st, g, me, rec, floor):
        st["own_next"] = _set_row(st["own_next"], g, me, int(rec["own_next"]))
        for k in self.DURABLE_WINDOWS:
            st[k] = _set_row(
                st[k], g, me,
                torch.as_tensor(rec[k], dtype=st[k].dtype,
                                device=st[k].device),
            )
        # own seen frontier covers the restored own row; cmt_row/exec_row
        # re-derive from the window content and the host exec floors
        sb = st["seen_bar"].clone()
        sb[g, me, me] = int(rec["own_next"])
        st["seen_bar"] = sb

    def __init__(
        self,
        num_groups: int,
        population: int,
        window: int = 32,
        config: ReplicaConfigEPaxos | None = None,
        device=None,
    ):
        super().__init__(num_groups, population, window, device)
        self.config = config or ReplicaConfigEPaxos()
        half = population // 2
        self.simple_q = half + 1
        self.super_q = (
            half + -(-half // 2) if self.config.optimized_quorum else 2 * half
        )
        self.super_q = max(self.simple_q, min(self.super_q, population))
        self._build_consts()

    def _build_consts(self) -> None:
        # per-kernel constants, built once on the device.  Rr: the stepped
        # (own) rows; R: replica ids of peers and of instance-space rows
        G, Rr, R, dev = self.G, self.rows, self.R, self.device
        self._rid = self.row_ids()[None, :].expand(G, Rr)
        self._eye = self.row_eye()               # own row vs peer
        self._eye_full = torch.eye(R, dtype=torch.bool, device=dev)[None]
        self._ar = arange32(R, dev)
        self._lar = arange32(Rr, dev)            # own-row positions
        self._gar = torch.arange(G, device=dev)

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int = 0):
        G, R, W, K = self.G, self.R, self.W, self.config.num_key_buckets
        z = self.zeros
        return {
            "own_next": z(G, R),
            # 2-D instance space [G, R, row, W] (+ deps [..., R]); window
            # position p of a row holds the column c == p (mod W), with
            # abs2 recording which c (-1 = empty)
            "abs2": self.full((G, R, R, W), -1),
            "st2": z(G, R, R, W),
            "bal2": z(G, R, R, W),
            "seq2": z(G, R, R, W),
            "val2": z(G, R, R, W),
            "noop2": z(G, R, R, W, dtype=torch.bool),
            "deps2": z(G, R, R, W, R),
            # preaccept-merge marker: True iff my stored PREACC copy's
            # (seq, deps) were bumped past the owner's lane by my tables
            "pbump2": z(G, R, R, W, dtype=torch.bool),
            # per-row frontiers
            "seen_bar": z(G, R, R),
            "cmt_row": z(G, R, R),
            "exec_row": z(G, R, R),
            "ext_row": z(G, R, R),
            # per-bucket interference tables
            "it_col": z(G, R, K, R),
            "it_seq": z(G, R, K, R),
            # per-row ballot ceiling + the column extent it protects
            "rbm": z(G, R, R),
            "rbm_ext": z(G, R, R),
            # liveness + recovery driver + own-row wedge detector
            "alive_cnt": self.full((G, R, R), self.config.alive_timeout),
            "rec_row": self.full((G, R), -1),
            "rec_bal": z(G, R),
            "stall_cnt": self.full((G, R), self.config.stall_timeout),
            "last_cmt": z(G, R),
            # engine-required aggregate bars
            "commit_bar": z(G, R),
            "exec_bar": z(G, R),
        }

    def zero_outbox(self):
        # the key order is the JAX kernel's: the netmodel takes its packed
        # broadcast-stack shape from the first 3-D int32 broadcast lane
        G, Rr, R, W, K = (self.G, self.rows, self.R, self.W,
                          self.config.num_key_buckets)
        z = self.zeros
        wl = lambda: z(G, Rr, W)  # noqa: E731
        wb = lambda: z(G, Rr, W, dtype=torch.bool)  # noqa: E731
        pair = lambda: z(G, Rr, R)  # noqa: E731
        return {
            "flags": z(G, Rr, R),
            "rp_abar": z(G, Rr, R),
            "rp_abase": z(G, Rr, R),
            "rp_pbar": z(G, Rr, R),
            "erp_row": pair(), "erp_bal": pair(), "erp_ext": pair(),
            "ow_abs": self.full((G, Rr, W), -1),
            "ow_phase": wl(), "ow_bal": wl(), "ow_seq": wl(), "ow_val": wl(),
            "ow_noop": wb(), "ow_deps": z(G, Rr, W, R),
            "tb_col": z(G, Rr, K, R),
            "tb_seq": z(G, Rr, K, R),
            "sb": z(G, Rr, R),
            "ro_row": self.full((G, Rr), -1), "ro_bal": z(G, Rr),
            "ro_abs": self.full((G, Rr, W), -1),
            "ro_phase": wl(), "ro_seq": wl(), "ro_val": wl(),
            "ro_noop": wb(), "ro_deps": z(G, Rr, W, R),
            "rv_row": self.full((G, Rr), -1), "rv_bal": z(G, Rr),
            "rv_abs": self.full((G, Rr, W), -1),
            "rv_st": wl(), "rv_vbal": wl(), "rv_seq": wl(), "rv_val": wl(),
            "rv_noop": wb(), "rv_deps": z(G, Rr, W, R),
            "rv_bump": wb(), "rv_cmt": z(G, Rr),
        }

    # ------------------------------------------------------------- helpers
    def _default_bal(self, row):
        """Default (pre-failover) ballot of a row."""
        return row | (1 << 8)

    def _row_slice(self, s, key, row):
        """Gather s[key][g, r, row[g, r]] -> [G, R, W(, R)]."""
        return s[key][self._gar[:, None], self._lar[None, :].long(),
                      row.long()]

    def _own_scatter(self, s, c, key, lane):
        """Scatter a [G, R, W(, R)] lane into s[key] at row = own rid."""
        if s[key].ndim == 5:
            sel = (
                self._ar[None, None, :, None, None]
                == c.rid[:, :, None, None, None]
            )
        else:
            sel = self._ar[None, None, :, None] == c.rid[:, :, None, None]
        s[key] = torch.where(sel, lane[:, :, None], s[key])

    def _bucket_gather(self, table, bucket):
        """table [G, A, K, R], bucket [G, A, ...] -> [G, A, ..., R]."""
        K = self.config.num_key_buckets
        G, A = table.shape[0], table.shape[1]
        dev = table.device
        gar = torch.arange(G, device=dev).reshape(
            (G,) + (1,) * (bucket.ndim - 1))
        aar = torch.arange(A, device=dev).reshape(
            (1, A) + (1,) * (bucket.ndim - 2))
        return table[gar, aar, torch.clamp(bucket, 0, K - 1).long()]

    def _bump_tables(self, s, m, abs_col, bucket, seq):
        """Fold applied instances (masked [G, R, row, W]) into tables."""
        K = self.config.num_key_buckets
        kar = arange32(K, self.device)[None, None, :, None, None]
        mb = m[:, :, None] & (bucket[:, :, None] == kar)  # [G,R,K,row,W]
        col_c = torch.where(mb, abs_col[:, :, None] + 1, 0).amax(dim=4)
        seq_c = torch.where(mb, seq[:, :, None], 0).amax(dim=4)
        s["it_col"] = torch.maximum(s["it_col"], col_c)
        s["it_seq"] = torch.maximum(s["it_seq"], seq_c)

    # ------------------------------------------------------------------ step
    PHASES: Tuple[Tuple[str, str], ...] = (
        ("liveness", "_liveness"),
        ("ingest_erp", "_ingest_erp"),
        ("ingest_recovery_drive", "_ingest_recovery_drive"),
        ("ingest_own_streams", "_ingest_own_streams"),
        ("leader_decide", "_leader_decide"),
        ("recovery_control", "_recovery_control"),
        ("propose", "_propose"),
        ("advance_commit_rows", "_advance_commit_rows"),
        ("execute", "_execute"),
        ("telemetry", "_phase_telemetry"),
        ("build_outbox", "_phase_build_outbox"),
    )

    def step(self, state, inbox, inputs) -> Tuple[Any, Any, StepEffects]:
        s = dict(state)
        c = SimpleNamespace(
            inbox=inbox, inputs=inputs, flags=inbox["flags"], old=state
        )
        c.rid = self._rid
        c.eye = self._eye
        c.heard = c.flags != 0

        self._run_phases(s, c)
        fx = self._effects(s, c)
        return s, c.out, fx

    # ========== liveness
    def _liveness(self, s, c):
        s["alive_cnt"] = torch.where(
            c.heard | c.eye,
            self.config.alive_timeout,
            torch.clamp(s["alive_cnt"] - 1, min=0),
        )

    # ========== ERP campaigns (acceptor side): raise per-row ballot ceiling
    def _ingest_erp(self, s, c):
        inbox = c.inbox
        erp_valid = (c.flags & ERP) != 0           # [G, R, src]
        rows = self._ar[None, None, :, None]
        m = erp_valid[:, :, None, :] & (
            inbox["erp_row"][:, :, None, :] == rows
        )
        best = torch.where(m, inbox["erp_bal"][:, :, None, :], 0).amax(dim=3)
        ext = torch.where(m, inbox["erp_ext"][:, :, None, :], 0).amax(dim=3)
        newer = best > s["rbm"]
        s["rbm"] = torch.where(newer, best, s["rbm"])
        s["rbm_ext"] = torch.where(
            newer, torch.maximum(s["rbm_ext"], ext), s["rbm_ext"]
        )

    # ========== shared ingestion core
    def _apply_lanes(self, s, c, lanes, bal_lane, row_mask):
        """Apply per-(row, window) lanes (abs/phase/seq/val/noop/deps) onto
        the 2-D log; lanes are [G, R, row, W(, R)] and ``row_mask`` says
        which (replica, row) pairs they target.  Phase 1 entries merge
        against my tables; phases 2/3 adopt verbatim.  Committed entries
        never regress.  Returns the applied mask."""
        K = self.config.num_key_buckets
        W = self.W
        l_abs, l_ph, l_seq, l_val, l_noop, l_deps = lanes
        pos_ok = (
            row_mask
            & (l_abs >= 0)
            & (torch.remainder(l_abs, W)
               == arange32(W, self.device)[None, None, None, :])
            & (l_ph >= PREACC)
            & (bal_lane > 0)
            & (l_abs >= s["exec_row"][..., None])
            & (l_abs < s["exec_row"][..., None] + W)
        )
        # ballot gates: entries under a row's ERP-protected extent need the
        # ceiling ballot; above it the default ballot is fine
        bal_ok = (bal_lane >= s["rbm"][..., None]) | (
            l_abs >= s["rbm_ext"][..., None]
        )
        pos_ok = pos_ok & bal_ok

        cur = s["abs2"] == l_abs
        fresh = pos_ok & ~cur & (
            (s["abs2"] < l_abs) | (s["st2"] == NULL)
        )
        upgrade = pos_ok & cur & (
            (l_ph > s["st2"]) | ((l_ph == s["st2"]) & (bal_lane > s["bal2"]))
        ) & ~((s["st2"] == COMMITTED) & (l_ph < COMMITTED))
        apply_m = fresh | upgrade

        # phase-1 merge against my (pre-application) tables
        bucket = torch.remainder(l_val, K)
        itc = self._bucket_gather(s["it_col"], bucket)  # [G,R,row,W,R]
        its = self._bucket_gather(s["it_seq"], bucket)
        not_own = (
            self._ar[None, None, None, None, :]
            != self._ar[None, None, :, None, None]
        )
        merge_seq = torch.maximum(
            l_seq, 1 + torch.where(not_own, its, 0).amax(dim=4)
        )
        merge_deps = torch.where(not_own, torch.maximum(l_deps, itc), l_deps)
        is_pre = l_ph == PREACC
        take_seq = torch.where(is_pre & fresh, merge_seq, l_seq)
        take_deps = torch.where(
            (is_pre & fresh)[..., None], merge_deps, l_deps
        )

        # did my phase-1 merge change the owner's attrs?  Tracked so
        # recovery can tell "copy == owner's original" (fast-commit
        # witness) from "copy already reflects MY interference view"
        bumped = (is_pre & fresh) & (
            (merge_seq > l_seq) | (merge_deps != l_deps).any(dim=4)
        )

        s["abs2"] = torch.where(apply_m, l_abs, s["abs2"])
        s["st2"] = torch.where(apply_m, l_ph, s["st2"])
        s["bal2"] = torch.where(apply_m, bal_lane, s["bal2"])
        s["seq2"] = torch.where(apply_m, take_seq, s["seq2"])
        s["val2"] = torch.where(apply_m, l_val, s["val2"])
        s["noop2"] = torch.where(apply_m, l_noop, s["noop2"])
        s["deps2"] = torch.where(apply_m[..., None], take_deps, s["deps2"])
        s["pbump2"] = torch.where(apply_m, bumped, s["pbump2"])
        self._bump_tables(s, apply_m & ~l_noop, l_abs, bucket, take_seq)
        return apply_m

    # ========== recovery drive lanes (acceptor side)
    def _ingest_recovery_drive(self, s, c):
        inbox = c.inbox
        has = (c.flags & RO) != 0                          # [G, R, src]
        rows = self._ar[None, None, :, None]
        m = has[:, :, None, :] & (inbox["ro_row"][:, None, None, :] == rows)
        eff = torch.where(m, inbox["ro_bal"][:, None, None, :], 0)
        best_bal = eff.amax(dim=3)                         # [G, R, row]
        best_src = first_argmax(eff, best_bal, 3).long()
        ok_row = (best_bal > 0) & (best_bal >= s["rbm"])
        s["rbm"] = torch.where(ok_row, best_bal, s["rbm"])

        gar = self._gar[:, None, None]

        def lane(name):
            return inbox[name][gar, best_src]  # [G, R, row, W(, R)]

        lanes = (lane("ro_abs"), lane("ro_phase"), lane("ro_seq"),
                 lane("ro_val"), lane("ro_noop"), lane("ro_deps"))
        bal_lane = torch.where(lanes[1] > 0, best_bal[..., None], 0)
        self._apply_lanes(s, c, lanes, bal_lane, ok_row[..., None])

    # ========== own-row preaccept/accept/commit stream ingestion
    def _ingest_own_streams(self, s, c):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        inbox = c.inbox
        beacon = ((c.flags & BEACON) != 0) & ~c.eye  # [G, R, src(=row)]

        bshape = (G, Rr, R, W)

        def lane(name, extra=()):
            return inbox[name][:, None].expand(bshape + extra)

        lanes = (
            lane("ow_abs"), lane("ow_phase"), lane("ow_seq"),
            lane("ow_val"), lane("ow_noop"), lane("ow_deps", (R,)),
        )
        bal_lane = lane("ow_bal")
        self._apply_lanes(s, c, lanes, bal_lane, beacon[..., None])

        # advance contiguous ingest frontiers: seen_bar per row walks over
        # stored entries (abs2 alignment), independent of this tick's lanes
        _, abs_w = range_cover(s["seen_bar"], s["seen_bar"] + W, W)
        present = (s["abs2"] == abs_w) & (s["st2"] >= PREACC)
        gap = (abs_w >= s["seen_bar"][..., None]) & ~present
        first_gap = torch.where(gap, abs_w, INF).amin(dim=3)
        s["seen_bar"] = _clip(first_gap, s["seen_bar"], s["seen_bar"] + W)
        # extent: max of my frontier and peers' reported frontiers
        sb_peers = inbox["sb"][:, None].expand(G, Rr, R, R)
        sb_max = torch.where(beacon[..., None], sb_peers, 0).amax(dim=2)
        s["ext_row"] = torch.maximum(
            torch.maximum(s["ext_row"], s["seen_bar"]), sb_max
        )

    # ========== command-leader decisions on own row (fast/slow/commit)
    def _leader_decide(self, s, c):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        K = self.config.num_key_buckets
        inbox = c.inbox
        rid = c.rid
        beacon = ((c.flags & BEACON) != 0) & ~c.eye

        st_o = self._row_slice(s, "st2", rid)
        abs_o = self._row_slice(s, "abs2", rid)
        bal_o = self._row_slice(s, "bal2", rid)
        seq_o = self._row_slice(s, "seq2", rid)
        val_o = self._row_slice(s, "val2", rid)
        deps_o = self._row_slice(s, "deps2", rid)  # [G, R, W, R]
        dbal = self._default_bal(rid)[..., None]
        live = (abs_o >= 0) & (abs_o < s["own_next"][..., None]) & (
            bal_o == dbal
        )

        # peers' ingest coverage of my row: the attested default-ballot
        # run [rp_abase, rp_pbar)
        pbar_mine = torch.where(beacon, inbox["rp_pbar"], 0)
        pbase_mine = inbox["rp_abase"]
        ing = (
            (pbase_mine[:, :, :, None] <= abs_o[:, :, None, :])
            & (pbar_mine[:, :, :, None] > abs_o[:, :, None, :])
        )  # [G,me,src,W]

        # fast-path identity reconstruction from peers' tables
        bucket = torch.remainder(val_o, K)
        gar4 = self._gar[:, None, None, None]
        par = self._ar[None, None, :, None].long()
        bidx = torch.clamp(bucket[:, :, None, :], 0, K - 1).long()
        tbc = inbox["tb_col"][gar4, par, bidx]
        tbs = inbox["tb_seq"][gar4, par, bidx]
        # tbc/tbs: [G, me, p, W, row]
        not_own = (
            self._ar[None, None, None, None, :]
            != rid[:, :, None, None, None]
        )
        extra_seq = 1 + torch.where(not_own, tbs, 0).amax(dim=4)
        seq_same = extra_seq <= seq_o[:, :, None, :]
        deps_same = ~(not_own & (tbc > deps_o[:, :, None, :, :])).any(dim=4)
        identical = seq_same & deps_same              # [G, me, p, W]

        fast_votes = 1 + _sum32(ing & identical, 2)
        ing_cnt = 1 + _sum32(ing, 2)
        alive_total = _sum32(s["alive_cnt"] > 0, 2)  # includes self

        pending = live & (st_o == PREACC)
        decide = pending & (
            (ing_cnt >= self.super_q)
            | ((ing_cnt >= self.simple_q)
               & (ing_cnt >= alive_total[..., None]))
        )
        fast = decide & (fast_votes >= self.super_q)
        slow = decide & ~fast

        # slow-path union attrs from ingested peers' tables + my own
        u_seq = torch.maximum(
            seq_o, torch.where(ing, extra_seq, 0).amax(dim=2)
        )
        u_deps = torch.maximum(
            deps_o, torch.where(ing[..., None], tbc, 0).amax(dim=2)
        )
        own_r = self._ar[None, None, None, :] == rid[..., None, None]
        u_deps = torch.where(own_r, deps_o, u_deps)

        # accept tally via the peers' contiguous accepted frontiers over
        # my row: an ack for column c needs c INSIDE the attested
        # half-open run [rp_abase, rp_abar)
        accing = live & (st_o == ACCEPTING)
        abar_mine = torch.where(beacon, inbox["rp_abar"], 0)
        abase_mine = inbox["rp_abase"]
        acc_cnt = 1 + _sum32(
            (abase_mine[:, :, :, None] <= abs_o[:, :, None, :])
            & (abar_mine[:, :, :, None] > abs_o[:, :, None, :]),
            2,
        )
        acc_done = accing & (acc_cnt >= self.simple_q)

        new_st = torch.where(
            fast | acc_done, COMMITTED, torch.where(slow, ACCEPTING, st_o)
        )
        new_seq = torch.where(slow, u_seq, seq_o)
        new_deps = torch.where(slow[..., None], u_deps, deps_o)
        self._own_scatter(s, c, "st2", new_st)
        self._own_scatter(s, c, "seq2", new_seq)
        self._own_scatter(s, c, "deps2", new_deps)
        # slow-path seq bumps also feed the tables
        own_sel = self._ar[None, None, :, None] == rid[:, :, None, None]
        self._bump_tables(
            s,
            (slow & ~self._row_slice(s, "noop2", rid))[:, :, None, :]
            & own_sel,
            abs_o[:, :, None, :].expand(G, Rr, R, W),
            bucket[:, :, None, :].expand(G, Rr, R, W),
            new_seq[:, :, None, :].expand(G, Rr, R, W),
        )

    # ========== recovery control: volunteer, campaign, decide, drive
    def _recovery_control(self, s, c):
        G, Rr, R = self.G, self.rows, self.R
        inbox = c.inbox
        rid = c.rid
        dead = (s["alive_cnt"] <= 0) & ~c.eye  # [G, R, peer]

        # volunteer for the nearest dead ring-predecessor whose in-between
        # predecessors are all dead too (deterministic, collision-free
        # among live replicas)
        vol_tgt = self.full((G, Rr), -1)
        taken = self.zeros(G, Rr, dtype=torch.bool)
        chain = torch.ones((G, Rr), dtype=torch.bool, device=self.device)
        for k in range(1, R):
            cand = torch.remainder(rid - k, R)
            cand_dead = _pick(dead, cand)
            # skip rows already fully recovered so a chain of adjacent
            # dead replicas gets each of its rows driven in turn
            cand_done = _pick(s["cmt_row"], cand) >= _pick(s["ext_row"], cand)
            pick = cand_dead & ~cand_done & chain & ~taken
            vol_tgt = torch.where(pick, cand, vol_tgt)
            taken = taken | pick
            chain = chain & cand_dead

        # own-row wedge detector -> self-ERP heal
        own_cmt = _pick(s["cmt_row"], rid)
        wedged = own_cmt < s["own_next"]
        prog = own_cmt > s["last_cmt"]
        s["last_cmt"] = own_cmt
        s["stall_cnt"] = torch.where(
            prog | ~wedged,
            self.config.stall_timeout,
            torch.clamp(s["stall_cnt"] - 1, min=0),
        )
        self_heal = wedged & (s["stall_cnt"] <= 0)
        vol_tgt = torch.where((vol_tgt < 0) & self_heal, rid, vol_tgt)

        # start / continue / finish / abort
        cur = s["rec_row"]
        cur_c = torch.clamp(cur, min=0)
        cur_dead = _pick(dead, cur_c)
        cur_done = _pick(s["cmt_row"], cur_c) >= _pick(s["ext_row"], cur_c)
        keep = (cur >= 0) & ~cur_done & (cur_dead | (cur == rid))
        start = (cur < 0) & (vol_tgt >= 0) | ((cur >= 0) & ~keep
                                              & (vol_tgt >= 0))
        tgt = torch.where(keep, cur, torch.where(start, vol_tgt, -1))
        s["rec_row"] = tgt
        tgt_c = torch.clamp(tgt, min=0)
        tgt_rbm = _pick(s["rbm"], tgt_c)
        # bid once per campaign; re-bid only when a strictly higher foreign
        # ballot appears
        need_bid = (tgt >= 0) & (start | (s["rec_bal"] < tgt_rbm))
        s["rec_bal"] = torch.where(
            need_bid,
            make_greater_ballot(tgt_rbm, rid),
            torch.where(tgt >= 0, s["rec_bal"], 0),
        )
        # claim the ballot ceiling locally
        tgt_ext = _pick(s["ext_row"], tgt_c)
        claim = (self._ar[None, None, :] == tgt[..., None]) & (
            tgt >= 0)[..., None]
        s["rbm"] = torch.where(
            claim, torch.maximum(s["rbm"], s["rec_bal"][..., None]), s["rbm"]
        )
        s["rbm_ext"] = torch.where(
            claim, torch.maximum(s["rbm_ext"], tgt_ext[..., None]),
            s["rbm_ext"],
        )

        # tally this tick's RV responses to my campaign
        rv_on = (c.flags & RV) != 0
        rv_row_in = inbox["rv_row"][:, None].expand(G, Rr, R)
        rv_bal_in = inbox["rv_bal"][:, None].expand(G, Rr, R)
        rv_mine = (
            rv_on
            & (rv_row_in == tgt[..., None])
            & (rv_bal_in == s["rec_bal"][..., None])
            & (tgt >= 0)[..., None]
        )
        c.rec_tgt = tgt
        c.rv_mine = rv_mine
        c.rec_have_q = 1 + _sum32(rv_mine, 2) >= self.simple_q

    # ========== proposals (every replica is a command leader)
    def _propose(self, s, c):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        K = self.config.num_key_buckets
        rid = c.rid
        n_prop = c.inputs["n_proposals"][:, None].to(I32).expand(G, Rr)
        # host-serving mode: ``prop_replica`` [G] names the ONE replica
        # proposing this tick, and value ids are used verbatim; without it
        # (device bench mode) the count splits across all command leaders
        # with rid-interleaved ids
        pr = c.inputs.get("prop_replica")
        if pr is None:
            pr2 = self.full((G, Rr), -1)
        else:
            pr2 = pr[:, None].to(I32).expand(G, Rr)
        host_mode = pr2 >= 0
        share = torch.where(
            host_mode,
            torch.where(rid == pr2, n_prop, 0),
            torch.div(n_prop, R, rounding_mode="floor")
            + (rid < torch.remainder(n_prop, R)).to(I32),
        )
        own_exec = _pick(s["exec_row"], rid)
        space = torch.clamp(own_exec + W - s["own_next"], min=0)
        n_new = torch.minimum(share, space)
        pv = c.inputs.get("prop_vids")
        if pv is not None:
            # never propose past the vid list's width: an out-of-range
            # gather would duplicate the last vid across distinct instances
            n_new = torch.clamp(n_new, max=pv.shape[1])
        vbase = c.inputs["value_base"][:, None].to(I32).expand(G, Rr)
        m_new, abs_new = range_cover(s["own_next"], s["own_next"] + n_new, W)
        off = abs_new - s["own_next"][..., None]
        # distinct value ids across replicas: interleave by rid; in host
        # mode an explicit per-tick vid LIST (``prop_vids`` [G, max_props])
        # may be supplied, minted in per-bucket residue classes
        if pv is not None:
            pmax = pv.shape[1]
            pvb = pv[:, None, :].to(I32).expand(G, Rr, pmax)
            host_vals = torch.gather(
                pvb, 2, torch.clamp(off, 0, pmax - 1).long()
            )
        else:
            host_vals = vbase[..., None] + off
        new_vals = torch.where(
            host_mode[..., None],
            host_vals,
            vbase[..., None] * R + rid[..., None] + off * R,
        )
        bucket = torch.remainder(new_vals, K)

        # seq0/deps0 from my tables
        itc = self._bucket_gather(s["it_col"], bucket)  # [G,R,W,row]
        its = self._bucket_gather(s["it_seq"], bucket)
        seq0 = 1 + its.amax(dim=3)
        deps0 = itc
        # intra-batch same-bucket chaining: rank among same-bucket batch
        # positions bumps seq; dep on the immediately preceding one
        own_sel = self._ar[None, None, None, :] == rid[..., None, None]
        for kb in range(K):
            mk = m_new & (bucket == kb)
            before = (
                mk[..., None, :] & mk[..., :, None]
                & (off[..., None, :] < off[..., :, None])
            )  # [G,R,W(i),W(j<i)]
            rank = _sum32(before, 3)
            seq0 = torch.where(mk, seq0 + rank, seq0)
            prev_bar = torch.where(
                before, abs_new[..., None, :] + 1, 0).amax(dim=3)
            deps0 = torch.where(
                own_sel & mk[..., None],
                torch.maximum(deps0, prev_bar[..., None]),
                deps0,
            )

        dlane = self._default_bal(rid)[..., None].expand(G, Rr, W)
        for key, lane in (
            ("abs2", torch.where(m_new, abs_new,
                                 self._row_slice(s, "abs2", rid))),
            ("st2", torch.where(m_new, PREACC,
                                self._row_slice(s, "st2", rid))),
            ("bal2", torch.where(m_new, dlane,
                                 self._row_slice(s, "bal2", rid))),
            ("seq2", torch.where(m_new, seq0,
                                 self._row_slice(s, "seq2", rid))),
            ("val2", torch.where(m_new, new_vals,
                                 self._row_slice(s, "val2", rid))),
            ("noop2", torch.where(m_new, False,
                                  self._row_slice(s, "noop2", rid))),
        ):
            self._own_scatter(s, c, key, lane)
        deps_lane = torch.where(
            m_new[..., None], deps0, self._row_slice(s, "deps2", rid)
        )
        self._own_scatter(s, c, "deps2", deps_lane)
        s["own_next"] = s["own_next"] + n_new
        own_sel3 = self._ar[None, None, :] == rid[..., None]
        s["seen_bar"] = torch.where(
            own_sel3, s["own_next"][..., None], s["seen_bar"]
        )
        s["ext_row"] = torch.maximum(s["ext_row"], s["seen_bar"])
        self._bump_tables(
            s,
            m_new[:, :, None, :] & own_sel3[..., None],
            abs_new[:, :, None, :].expand(G, Rr, R, W),
            bucket[:, :, None, :].expand(G, Rr, R, W),
            seq0[:, :, None, :].expand(G, Rr, R, W),
        )
        c.n_new = n_new

    # ========== per-row contiguous commit frontier
    def _advance_commit_rows(self, s, c):
        W = self.W
        _, abs_w = range_cover(s["cmt_row"], s["cmt_row"] + W, W)
        ok = (s["abs2"] == abs_w) & (s["st2"] == COMMITTED)
        fail = (abs_w >= s["cmt_row"][..., None]) & ~ok
        first_fail = torch.where(fail, abs_w, INF).amin(dim=3)
        s["cmt_row"] = _clip(first_fail, s["cmt_row"], s["cmt_row"] + W)
        s["commit_bar"] = s["cmt_row"].sum(dim=2, dtype=I32)

    # ========== execution: row-frontier heuristic with cycle breaking
    def _execute(self, s, c):
        R, W = self.R, self.W
        if not self.config.exec_follows_commit:
            floor = c.inputs["exec_floor_rows"].to(I32)
            s["exec_row"] = _clip(floor, s["exec_row"], s["cmt_row"])
            s["exec_bar"] = s["exec_row"].sum(dim=2, dtype=I32)
            return
        gar = self._gar[:, None, None]
        rar = self._lar[None, :, None].long()
        rowar = self._ar[None, None, :].long()
        ar = self._ar
        no_self = ~self._eye_full[None]
        # the (seq, row) order of the cycle break
        row_less = ar[None, None, :, None] < ar[None, None, None, :]
        # R passes per tick: a row-cycle of m rows drains one instance per
        # pass (min key first), so R passes keep up with a full round of
        # per-row commits each tick
        go_passes, seq_passes, val_passes = [], [], []
        for _ in range(R):
            pos = torch.remainder(s["exec_row"], W).long()
            x_seq = s["seq2"][gar, rar, rowar, pos]
            x_deps = s["deps2"][gar, rar, rowar, pos]   # [G, R, a, b]
            committed = s["exec_row"] < s["cmt_row"]
            edge = (x_deps > s["exec_row"][:, :, None, :]) & no_self
            edge = edge & committed[..., None]
            clo = edge
            for _ in range(max(1, (R - 1).bit_length())):
                # boolean squaring: (clo @ clo)[a, c] = any_b clo[a, b] &
                # clo[b, c] (the JAX int32 einsum, which CUDA lacks)
                nxt = (clo[..., :, :, None] & clo[..., None, :, :]).any(
                    dim=-2)
                clo = clo | nxt
            key_less = (x_seq[:, :, :, None] < x_seq[:, :, None, :]) | (
                (x_seq[:, :, :, None] == x_seq[:, :, None, :]) & row_less
            )
            cyc_ok = (
                clo.transpose(2, 3)
                & committed[:, :, None, :]
                & key_less
            )
            blocked = (edge & ~cyc_ok).any(dim=3)
            go = committed & ~blocked
            s["exec_row"] = s["exec_row"] + go.to(I32)
            go_passes.append(go)
            x_val = s["val2"][gar, rar, rowar, pos]
            seq_passes.append(torch.where(go, x_seq, 0))
            val_passes.append(torch.where(go, x_val, 0))
        s["exec_bar"] = s["exec_row"].sum(dim=2, dtype=I32)
        # per-pass execution events [G, R, row, pass] for lossless
        # host-side order reconstruction (pass order, then (seq, row))
        c.exec_go = torch.stack(go_passes, dim=-1)
        c.exec_seq = torch.stack(seq_passes, dim=-1)
        c.exec_val = torch.stack(val_passes, dim=-1)

    # ========== outbox
    def _ring_abs(self, top):
        """[..., W]: largest col < top at each ring position (may be < 0 =
        empty; consumers also check the stored abs lanes)."""
        W = self.W
        p = arange32(W, top.device)
        t = top[..., None]
        return t - 1 - torch.remainder(t - 1 - p, W)

    def _build_outbox(self, s, c):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        out = self.zero_outbox()
        rid = c.rid
        ns_mask = (~c.eye).expand(G, Rr, R)
        oflags = flag_bits(ns_mask, BEACON)

        # own-row stream straight from the 2-D log
        st_o = self._row_slice(s, "st2", rid)
        abs_o = self._row_slice(s, "abs2", rid)
        live = (st_o > NULL) & (abs_o >= 0)
        out["ow_abs"] = torch.where(live, abs_o, -1)
        out["ow_phase"] = torch.where(live, st_o, 0)
        out["ow_bal"] = torch.where(
            live, self._row_slice(s, "bal2", rid), 0)
        out["ow_seq"] = torch.where(
            live, self._row_slice(s, "seq2", rid), 0)
        out["ow_val"] = torch.where(
            live, self._row_slice(s, "val2", rid), 0)
        out["ow_noop"] = torch.where(
            live, self._row_slice(s, "noop2", rid), False
        )
        out["ow_deps"] = torch.where(
            live[..., None], self._row_slice(s, "deps2", rid), 0
        )
        out["tb_col"] = s["it_col"]
        out["tb_seq"] = s["it_seq"]
        out["sb"] = s["seen_bar"]

        # rp_abar: per destination row owner d, this sender's CONTIGUOUS
        # accepted frontier over d's row, column-identified and at the
        # row's DEFAULT ballot (see the JAX producer note on why a
        # per-position bitmask and recovery-ballot entries are excluded)
        dbal_rows = self._default_bal(self._ar)[None, None, :, None]
        _, acc_absw = range_cover(s["exec_row"], s["exec_row"] + W, W)
        acc_cov = (
            (s["abs2"] == acc_absw)
            & (s["st2"] >= ACCEPTING)
            & (s["bal2"] == dbal_rows)
        )
        acc_gap = (acc_absw >= s["exec_row"][..., None]) & ~acc_cov
        acc_first = torch.where(acc_gap, acc_absw, INF).amin(dim=3)
        # the attestation is the HALF-OPEN run [rp_abase, rp_abar)
        out["rp_abase"] = s["exec_row"]
        out["rp_abar"] = _clip(
            acc_first, s["exec_row"], s["exec_row"] + W
        )  # [G, R, row] -> per-pair [G, src, dst=row]
        # the PREACC-level run backs the owner's fast-path ingest count
        pre_cov = (
            (s["abs2"] == acc_absw)
            & (s["st2"] >= PREACC)
            & (s["bal2"] == dbal_rows)
        )
        pre_gap = (acc_absw >= s["exec_row"][..., None]) & ~pre_cov
        pre_first = torch.where(pre_gap, acc_absw, INF).amin(dim=3)
        out["rp_pbar"] = _clip(pre_first, s["exec_row"], s["exec_row"] + W)

        # ERP campaign
        rec_on = s["rec_row"] >= 0
        do_erp = rec_on[..., None] & ns_mask
        oflags = oflags | flag_bits(do_erp, ERP)
        out["erp_row"] = torch.where(do_erp, s["rec_row"][..., None], 0)
        out["erp_bal"] = torch.where(do_erp, s["rec_bal"][..., None], 0)
        tgt_ext = _pick(s["ext_row"], torch.clamp(s["rec_row"], min=0))
        out["erp_ext"] = torch.where(do_erp, tgt_ext[..., None], 0)

        # RV responses: serve the highest-ballot ERP heard this tick
        erp_in = (c.flags & ERP) != 0
        erp_bal_in = torch.where(erp_in, c.inbox["erp_bal"], 0)
        best_bal = erp_bal_in.amax(dim=2)
        best_src = first_argmax(erp_bal_in, best_bal, 2)
        srow = _pick(c.inbox["erp_row"], best_src)
        srow_c = torch.clamp(srow, min=0)
        # never answer a campaign below a ballot already promised for that
        # row (only the max concurrent campaign gets served)
        srow_rbm = _pick(s["rbm"], srow_c)
        serve = (best_bal > 0) & (best_bal >= srow_rbm)
        out["rv_row"] = torch.where(serve, srow, -1)
        out["rv_bal"] = torch.where(serve, best_bal, 0)
        rv_live = (self._row_slice(s, "st2", srow_c) > NULL) & serve[
            ..., None
        ]
        out["rv_abs"] = torch.where(
            rv_live, self._row_slice(s, "abs2", srow_c), -1
        )
        out["rv_st"] = torch.where(
            rv_live, self._row_slice(s, "st2", srow_c), 0)
        out["rv_vbal"] = torch.where(
            rv_live, self._row_slice(s, "bal2", srow_c), 0
        )
        out["rv_seq"] = torch.where(
            rv_live, self._row_slice(s, "seq2", srow_c), 0
        )
        out["rv_val"] = torch.where(
            rv_live, self._row_slice(s, "val2", srow_c), 0
        )
        out["rv_noop"] = torch.where(
            rv_live, self._row_slice(s, "noop2", srow_c), False
        )
        out["rv_deps"] = torch.where(
            rv_live[..., None], self._row_slice(s, "deps2", srow_c), 0
        )
        out["rv_bump"] = torch.where(
            rv_live, self._row_slice(s, "pbump2", srow_c), False
        )
        # my committed frontier over the served row: columns below it are
        # committed HERE even if my window already slid past their copies
        out["rv_cmt"] = torch.where(serve, _pick(s["cmt_row"], srow_c), 0)
        do_rv = serve[..., None] & ns_mask
        oflags = oflags | flag_bits(do_rv, RV)

        # RO drive lanes from the decision ladder
        ro = self._recovery_apply(s, c)
        out.update(ro)
        do_ro = (out["ro_row"] >= 0)[..., None] & ns_mask
        oflags = oflags | flag_bits(do_ro, RO)

        out["flags"] = oflags
        return out

    # ========== recovery decision ladder (recoverer side)
    def _recovery_apply(self, s, c):
        G, Rr, R, W = self.G, self.rows, self.R, self.W
        K = self.config.num_key_buckets
        inbox = c.inbox
        tgt = c.rec_tgt
        tgt_c = torch.clamp(tgt, min=0)
        rv_mine = c.rv_mine                      # [G, me, src]

        tgt_ext = _pick(s["ext_row"], tgt_c)
        tgt_cmt = _pick(s["cmt_row"], tgt_c)
        my_ring = self._ring_abs(tgt_ext)        # [G, R, W]

        def rin(name, extra=()):
            return inbox[name][:, None].expand((G, Rr, R, W) + extra)

        align = (
            rv_mine[..., None]
            & (rin("rv_abs") == my_ring[:, :, None, :])
            & (my_ring[:, :, None, :] >= 0)
        )
        rv_st = torch.where(align, rin("rv_st"), 0)
        rv_vbal = torch.where(align, rin("rv_vbal"), 0)
        rv_seq = rin("rv_seq")
        rv_val = rin("rv_val")
        rv_noop = rin("rv_noop")
        rv_deps = rin("rv_deps", (R,))
        rv_bump = torch.where(align, rin("rv_bump"), False)
        # highest committed frontier any responder reports for the row:
        # columns below it are committed SOMEWHERE even if every visible
        # window slid past them
        rv_cmt_in = inbox["rv_cmt"][:, None].expand(G, Rr, R)
        resp_cmt = torch.where(rv_mine, rv_cmt_in, 0).amax(dim=2)

        own_st = self._row_slice(s, "st2", tgt_c)
        own_abs = self._row_slice(s, "abs2", tgt_c)
        own_ok = own_abs == my_ring
        own_st = torch.where(own_ok, own_st, 0)
        own_vbal = torch.where(own_ok, self._row_slice(s, "bal2", tgt_c), 0)
        own_seq = self._row_slice(s, "seq2", tgt_c)
        own_val = self._row_slice(s, "val2", tgt_c)
        own_noop = self._row_slice(s, "noop2", tgt_c)
        own_deps = self._row_slice(s, "deps2", tgt_c)

        unresolved = (
            (my_ring >= tgt_cmt[..., None])
            & (my_ring < tgt_ext[..., None])
            & (own_st < COMMITTED)
        )
        act = c.rec_have_q[..., None] & unresolved & (tgt >= 0)[..., None]

        def from_src(lane, ownl, src, use_own):
            # lane [G, R, src, W]; src [G, R, W]
            got = torch.gather(lane, 2, src[:, :, None, :].long())[:, :, 0]
            return torch.where(use_own, ownl, got)

        def from_src_d(lane, ownl, src, use_own):
            # lane [G, R, src, W, R]; src [G, R, W]
            idx = src[:, :, None, :, None].long().expand(G, Rr, 1, W, R)
            got = torch.gather(lane, 2, idx)[:, :, 0]
            return torch.where(use_own[..., None], ownl, got)

        # ladder 1: committed copy anywhere
        own_cmt = own_st >= COMMITTED
        rv_cmtd = rv_st >= COMMITTED
        any_cmt = act & (rv_cmtd.any(dim=2) | own_cmt)
        csrc = first_true(rv_cmtd, 2)
        c_seq = from_src(rv_seq, own_seq, csrc, own_cmt)
        c_val = from_src(rv_val, own_val, csrc, own_cmt)
        c_noop = from_src(rv_noop, own_noop, csrc, own_cmt)
        c_deps = from_src_d(rv_deps, own_deps, csrc, own_cmt)

        # columns committed at some responder but not visible as committed
        # copies anywhere in the quorum: leave them alone
        lost = (my_ring < resp_cmt[..., None]) & ~any_cmt

        # ladder 2: accepting copy at the max voted ballot
        accm = rv_st == ACCEPTING
        own_acc = own_st == ACCEPTING
        acc_best = torch.maximum(
            torch.where(accm, rv_vbal, 0).amax(dim=2),
            torch.where(own_acc, own_vbal, 0),
        )
        any_acc = act & ~any_cmt & ~lost & (acc_best > 0)
        use_own_a = own_acc & (own_vbal >= acc_best)
        acc_key = torch.where(accm, rv_vbal, -1)
        asrc = first_argmax(acc_key, acc_key.amax(dim=2), 2)
        a_seq = from_src(rv_seq, own_seq, asrc, use_own_a)
        a_val = from_src(rv_val, own_val, asrc, use_own_a)
        a_noop = from_src(rv_noop, own_noop, asrc, use_own_a)
        a_deps = from_src_d(rv_deps, own_deps, asrc, use_own_a)

        # ladder 3: an UNBUMPED preaccept copy at the row's default ballot
        # (the only attrs a fast commit can decide; see the JAX note)
        dbal = self._default_bal(tgt_c)[..., None]        # [G, R, 1]
        pre_all = (rv_st == PREACC) & (rv_vbal == dbal[:, :, None, :])
        pre = pre_all & ~rv_bump
        own_pre_all = (own_st == PREACC) & (own_vbal == dbal)
        own_bump = own_ok & self._row_slice(s, "pbump2", tgt_c)
        own_pre = own_pre_all & ~own_bump
        any_pre_rv = pre.any(dim=2)
        ident = act & ~any_cmt & ~any_acc & ~lost & (any_pre_rv | own_pre)
        use_own_i = own_pre & ~any_pre_rv
        isrc = first_true(pre, 2)
        i_seq = from_src(rv_seq, own_seq, isrc, use_own_i)
        i_val = from_src(rv_val, own_val, isrc, use_own_i)
        i_noop = from_src(rv_noop, own_noop, isrc, use_own_i)
        i_deps = from_src_d(rv_deps, own_deps, isrc, use_own_i)

        # ladder 4: only bumped preaccepts -> re-propose the voted value
        # with a fresh merge from my tables; ladder 5: nothing -> no-op
        any_pre_all_rv = pre_all.any(dim=2)
        any_pre = any_pre_all_rv | own_pre_all
        repro = act & ~any_cmt & ~any_acc & ~lost & ~ident & any_pre
        noopf = act & ~any_cmt & ~any_acc & ~lost & ~ident & ~any_pre
        use_own_p = own_pre_all & ~any_pre_all_rv
        psrc = first_true(pre_all, 2)
        p_val = from_src(rv_val, own_val, psrc, use_own_p)
        p_noop = from_src(rv_noop, own_noop, psrc, use_own_p)
        pbucket = torch.remainder(p_val, K)
        itc = self._bucket_gather(s["it_col"], pbucket)
        its = self._bucket_gather(s["it_seq"], pbucket)
        p_seq = 1 + its.amax(dim=3)
        p_deps = itc

        phase = torch.where(
            any_cmt,
            COMMITTED,
            flag_bits(any_acc | ident | repro | noopf, ACCEPTING),
        )
        o_seq = torch.where(any_cmt, c_seq, torch.where(
            any_acc, a_seq, torch.where(ident, i_seq, torch.where(
                repro, p_seq, 1))))
        o_val = torch.where(any_cmt, c_val, torch.where(
            any_acc, a_val, torch.where(ident, i_val, torch.where(
                repro, p_val, 0))))
        o_noop = torch.where(any_cmt, c_noop, torch.where(
            any_acc, a_noop, torch.where(ident, i_noop, torch.where(
                repro, p_noop, True))))
        o_deps = torch.where(any_cmt[..., None], c_deps, torch.where(
            any_acc[..., None], a_deps, torch.where(
                ident[..., None], i_deps, torch.where(
                    repro[..., None], p_deps, 0))))

        # accept tally for driven instances: responders ACCEPTING at
        # exactly my ERP ballot (rec_bal embeds my replica id)
        racc = 1 + _sum32(
            align & (rv_st == ACCEPTING)
            & (rv_vbal == s["rec_bal"][..., None, None]),
            2,
        )
        promote = act & (phase == ACCEPTING) & (racc >= self.simple_q)
        phase = torch.where(promote, COMMITTED, phase)

        # store outcomes locally (the recoverer is an acceptor too)
        tgt_sel = (
            self._ar[None, None, :, None] == tgt[:, :, None, None]
        ) & (tgt >= 0)[:, :, None, None]
        act4 = tgt_sel & (phase > 0)[:, :, None, :]
        keep_cmt = act4 & (s["st2"] == COMMITTED) & (
            phase[:, :, None, :] < COMMITTED
        )
        act4 = act4 & ~keep_cmt
        s["abs2"] = torch.where(act4, my_ring[:, :, None, :], s["abs2"])
        s["st2"] = torch.where(act4, phase[:, :, None, :], s["st2"])
        s["bal2"] = torch.where(
            act4, s["rec_bal"][:, :, None, None], s["bal2"])
        s["seq2"] = torch.where(act4, o_seq[:, :, None, :], s["seq2"])
        s["val2"] = torch.where(act4, o_val[:, :, None, :], s["val2"])
        s["noop2"] = torch.where(act4, o_noop[:, :, None, :], s["noop2"])
        s["deps2"] = torch.where(
            act4[..., None], o_deps[:, :, None, :, :], s["deps2"]
        )

        rec_on = (tgt >= 0) & c.rec_have_q
        return {
            "ro_row": torch.where(rec_on, tgt, -1),
            "ro_bal": torch.where(rec_on, s["rec_bal"], 0),
            "ro_abs": torch.where(
                rec_on[..., None] & (phase > 0), my_ring, -1),
            "ro_phase": torch.where(rec_on[..., None], phase, 0),
            "ro_seq": torch.where(rec_on[..., None], o_seq, 0),
            "ro_val": torch.where(rec_on[..., None], o_val, 0),
            "ro_noop": torch.where(rec_on[..., None], o_noop, False),
            "ro_deps": torch.where(rec_on[..., None, None], o_deps, 0),
        }

    # ----------------------------------------------------------- telemetry
    def _telemetry(self, old, s, c) -> dict:
        """Metric lanes: commits are the committed-row delta, occupancy is
        the replica's OWN proposal row, and recovery drives count as
        elections (as the JAX kernel reports them)."""
        tel = {
            "commits": torch.clamp(
                s["cmt_row"].sum(dim=2, dtype=I32)
                - old["cmt_row"].sum(dim=2, dtype=I32),
                min=0,
            ),
            "proposals": c.n_new,
            "elections": (s["rec_row"] >= 0) & (old["rec_row"] < 0),
        }
        # own-row live span: columns minted but not yet executed on this
        # replica's own proposal row
        exec_own = _pick(s["exec_row"], c.rid)
        tel["win_occupancy_hw"] = torch.clamp(
            s["own_next"] - exec_own, 0, self.window
        )
        return tel

    # ------------------------------------------------------------- effects
    def _effects(self, s, c):
        G, Rr, R = self.G, self.rows, self.R
        zero = self.zeros(G, Rr, R, R, dtype=torch.bool)
        return StepEffects(
            commit_bar=s["commit_bar"],
            exec_bar=s["exec_bar"],
            extra={
                "n_accepted": c.n_new,
                "cmt_row": s["cmt_row"],
                "exec_row": s["exec_row"],
                "rec_row": s["rec_row"],
                "exec_go": getattr(c, "exec_go", zero),
                "exec_seq": getattr(c, "exec_seq", zero.to(I32)),
                "exec_val": getattr(c, "exec_val", zero.to(I32)),
            },
        )
