"""The port's Raft, CRaft and Crossword kernels against the JAX package,
exactly.

The recipe of ``tests/test_torch_engine.py``: both engines start from the
JAX boot state carried across through ``summerset_tpu_torch.convert`` and
run three windows of the same per-tick inputs (proposals every tick,
replica 1 paused at tick 3, a durable reset of replica 1 in window 1, plus
the case's schedule).  After every window the sha256 digest of every
state leaf, the stacked effects and the netstate must be equal, and so
must the state signatures (leaf names, dtypes, shapes).  Tolerance: none,
every compared value is an integer or a bool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summerset_tpu.core import Engine as JEngine
from summerset_tpu.core import NetConfig as JNet
from summerset_tpu.core.engine import reset_durable_rows as jreset
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.craft import ReplicaConfigCRaft as JCR
from summerset_tpu.protocols.crossword import ReplicaConfigCrossword as JCW
from summerset_tpu.protocols.raft import ReplicaConfigRaft as JRA
from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import Engine as TEngine
from summerset_tpu_torch.core import NetConfig as TNet
from summerset_tpu_torch.core.engine import reset_durable_rows
from summerset_tpu_torch.core.telemetry import LANE_IDX
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.craft import ReplicaConfigCRaft as TCR
from summerset_tpu_torch.protocols.crossword import (
    ReplicaConfigCrossword as TCW,
)
from summerset_tpu_torch.protocols.raft import ReplicaConfigRaft as TRA
from test_torch_engine import _common_start, _digest_window, _signature

G, R, W, P = 8, 5, 32, 4
TICKS = 16      # per window
WINDOWS = 3

JITTER = dict(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
              max_delay_ticks=3)
FAST = dict(hear_timeout_lo=5, hear_timeout_hi=9)

CONFIGS = {"raft": (JRA, TRA), "craft": (JCR, TCR), "crossword": (JCW, TCW)}

# name -> (protocol, config kwargs, net kwargs, schedule)
CASES = {
    "raft-pairwise": ("raft", {}, {}, ""),
    "raft-collective-jitter-drops-demote": (
        "raft", dict(tally="collective", **FAST), JITTER, "demote"),
    "raft-cold-election-leader-crash": (
        "raft", dict(init_leader=-1, **FAST), {}, "crash-elected"),
    "raft-install-snapshot": ("raft", {}, {}, "isolate"),
    "craft-ft1": ("craft", dict(fault_tolerance=1), {}, ""),
    "craft-ft1-full-copy-fallback": (
        "craft", dict(fault_tolerance=1, alive_timeout=6), {}, "pause34"),
    "craft-ft1-collective-crash-jitter": (
        "craft", dict(fault_tolerance=1, tally="collective", **FAST),
        JITTER, "crash"),
    "crossword-default": ("crossword", {}, {}, ""),
    "crossword-t10-spr-override": (
        "crossword", dict(rs_total_shards=10), {}, "override"),
    "crossword-ft2-slow-peer": (
        "crossword", dict(fault_tolerance=2), {}, "slow"),
}

ISOLATED = 2             # the follower cut off in "isolate"
ISOLATE_TICKS = (2, 26)  # absolute ticks [from, to)
PAUSED = (3, 4)          # the followers paused in "pause34"
PAUSE_TICKS = (20, 36)
SLOW = 4                 # the peer alive one tick in SLOW_PERIOD in "slow"
SLOW_PERIOD = 12
OVERRIDE_SPR = 4         # spr_override of the odd groups in "override"


def _kernels(proto, cfg, g=G):
    jcfg, tcfg = CONFIGS[proto]
    cfg = dict(max_proposals_per_tick=P, **cfg)
    return (jmake(proto, g, R, W, jcfg(**cfg)),
            tmake(proto, g, R, W, tcfg(**cfg), device="cpu"))


def _window_seq(w, schedule, leaders):
    """One window's per-tick inputs as numpy arrays.  ``leaders`` [G] is
    each group's leader at the end of window 0 (the crash target of
    ``crash-elected``)."""
    t = np.arange(TICKS, dtype=np.int32)
    abs_t = w * TICKS + t
    alive = np.ones((TICKS, G, R), bool)
    alive[3, :, 1] = False
    reset = np.zeros((TICKS, G, R), bool)
    if w == 1:
        reset[5, :, 1] = True
    seq = {
        "n_proposals": np.full((TICKS, G), P, np.int32),
        "value_base": np.broadcast_to(
            (abs_t * P)[:, None], (TICKS, G)).astype(np.int32),
    }
    if schedule == "crash":
        alive[abs_t >= 10, :, 0] = False
    elif schedule == "crash-elected" and w >= 1:
        # the leader elected in window 0 dies at absolute tick 20
        alive[abs_t >= 20] &= (
            np.arange(R)[None, :] != leaders[:, None])[None]
    elif schedule == "pause34":
        on = (abs_t >= PAUSE_TICKS[0]) & (abs_t < PAUSE_TICKS[1])
        for r in PAUSED:
            alive[on, :, r] = False
    elif schedule == "slow":
        alive[(abs_t >= 8) & (abs_t % SLOW_PERIOD != 0), :, SLOW] = False
    elif schedule == "isolate":
        link = np.ones((TICKS, G, R, R), bool)
        on = (abs_t >= ISOLATE_TICKS[0]) & (abs_t < ISOLATE_TICKS[1])
        link[on, :, ISOLATED, :] = False
        link[on, :, :, ISOLATED] = False
        link[:, :, ISOLATED, ISOLATED] = True
        seq["link_up"] = link
    elif schedule == "demote":
        demote = np.zeros((TICKS, G, R), bool)
        if w == 1:
            demote[2:4, :, 0] = True
        seq["demote"] = demote
    elif schedule == "override":
        ov = np.zeros((TICKS, G), np.int32)
        if w >= 1:
            ov[:, 1::2] = OVERRIDE_SPR
        seq["spr_override"] = ov
    seq["alive"] = alive
    seq["reset"] = reset
    return seq


def _run_both(name):
    proto, cfg, net, schedule = CASES[name]
    jk, tk = _kernels(proto, cfg)
    jeng = JEngine(jk, netcfg=JNet(**net), seed=7)
    teng = TEngine(tk, netcfg=TNet(**net), seed=7, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    jd, td, finals = [], [], []
    leaders = None
    for w in range(WINDOWS):
        seq = _window_seq(w, schedule, leaders)
        js, jns, jfx = jeng.run_ticks(
            js, jns, {k: jnp.asarray(v) for k, v in seq.items()},
            collect=True)
        ts, tns, tfx = teng.run_ticks(ts, tns, seq, collect=True)
        jd.append(_digest_window(
            js, jns, {"commit_bar": jfx.commit_bar, "exec_bar": jfx.exec_bar,
                      "extra": jfx.extra}))
        tsn = to_numpy(ts)
        assert _signature(tsn) == _signature(js), f"window {w}"
        td.append(_digest_window(
            tsn, to_numpy(tns),
            {"commit_bar": tfx.commit_bar.numpy(),
             "exec_bar": tfx.exec_bar.numpy(),
             "extra": {k: v.numpy() for k, v in tfx.extra.items()}}))
        finals.append((tsn, {k: v.numpy() for k, v in tfx.extra.items()}))
        if w == 0:
            leaders = _leader_rows(tsn)
    return jd, td, finals


def _leader_rows(st):
    """Each group's leader replica: the Raft family's ``is_leader`` row,
    else the first replica that names itself leader."""
    if "is_leader" in st:
        return np.argmax(st["is_leader"], axis=1)
    return np.argmax(st["leader"] == np.arange(R)[None, :], axis=1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_digests_equal_jax(name):
    jd, td, finals = _run_both(name)
    assert td == jd
    final = finals[-1][0]
    assert int(final["commit_bar"].max()) > 0, "nothing committed"
    schedule = CASES[name][3]
    if schedule in ("crash", "crash-elected", "demote"):
        # a failover ran: someone campaigned
        assert int(final["telem"][..., LANE_IDX["elections"]].sum()) > 0
    if schedule == "crash":
        # most groups committed more after their leader died at tick 10
        st0 = finals[0][0]
        after = final["commit_bar"][:, 1:].max(axis=1)
        assert (after > st0["commit_bar"].max(axis=1)).sum() >= G // 2
    if schedule == "crash-elected":
        # window 0 elected one leader per group from a cold start ...
        st0 = finals[0][0]
        assert st0["is_leader"].sum(axis=1).tolist() == [1] * G
        assert (st0["commit_bar"].max(axis=1) > 0).all()
        # ... and each group committed more after that leader died
        alive = np.arange(R)[None, :] != _leader_rows(st0)[:, None]
        after = np.where(alive, final["commit_bar"], 0).max(axis=1)
        assert (after > st0["commit_bar"].max(axis=1)).all()
    if schedule == "isolate":
        # the follower fell more than a window behind while cut off ...
        st0 = finals[0][0]
        assert (st0["log_end"].max(axis=1)
                - st0["log_end"][:, ISOLATED] > W).all()
        # ... and only an install-snapshot can bring it level again (a
        # follower learns the commit bar a tick or two after its leader)
        assert (final["commit_bar"][:, ISOLATED]
                >= final["commit_bar"].max(axis=1) - 2 * P).all()
    if CASES[name][0] == "craft":
        # shard availability gates execution at the followers
        assert (final["full_bar"] <= final["commit_bar"]).all()
    if schedule == "pause34":
        lead = [st["win_full"][np.arange(G), _leader_rows(st)]
                for st, _ in finals]
        filled = [st["win_abs"][np.arange(G), _leader_rows(st)] >= 0
                  for st, _ in finals]
        # coded slots before two followers went down (window 0), full-copy
        # ones while they were down (end of window 1), coded after
        assert lead[1].any()
        assert (filled[0] & ~lead[0]).any()
        assert (filled[2] & ~lead[2]).any()
    if schedule == "override":
        spr = final["win_spr"][np.arange(G), _leader_rows(final)]
        filled = final["win_abs"][np.arange(G), _leader_rows(final)] >= 0
        assert (spr[1::2][filled[1::2]] == OVERRIDE_SPR).all()
        assert (spr[0::2][filled[0::2]] == 2).all()
    if schedule == "slow":
        # the lagging peer widened the leaders' assignment at some tick
        cur = np.concatenate([fx["cur_spr"] for _, fx in finals[1:]])
        assert int(cur.max()) > 1


@pytest.mark.parametrize("proto,cfg", [
    ("raft", {}),
    ("craft", dict(fault_tolerance=1)),
    ("crossword", dict(rs_total_shards=10)),
])
def test_reset_and_restore_durable_match_jax(proto, cfg):
    jk, tk = _kernels(proto, cfg)
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    seq = _window_seq(0, "", None)
    js, jns, _ = jeng.run_ticks(
        js, jns, {k: jnp.asarray(v) for k, v in seq.items()})
    ts, tns, _ = teng.run_ticks(ts, tns, seq)
    mask = np.zeros((G, R), bool)
    mask[::2, 0] = True
    jr = jreset(jk, js, jnp.asarray(mask), jeng._boot)
    tr = reset_durable_rows(tk, ts, torch.from_numpy(mask), teng._boot)
    trn = to_numpy(tr)
    for k in jr:
        np.testing.assert_array_equal(trn[k], np.asarray(jr[k]), err_msg=k)
    rec = {k: np.asarray(js[k][1, 2]).tolist()
           for k in jk.DURABLE_SCALARS + jk.DURABLE_WINDOWS}
    jst, tst = dict(jeng._boot), dict(teng._boot)
    jk.restore_durable(jst, 1, 2, rec, floor=5)
    tk.restore_durable(tst, 1, 2, rec, floor=5)
    tn = to_numpy(tst)
    for k in jst:
        np.testing.assert_array_equal(tn[k], np.asarray(jst[k]), err_msg=k)


def test_kernel_declarations_match_jax():
    """Broadcast and tally lanes, durable leaves and phase tables are
    declared as the JAX kernels declare them."""
    for proto, cfg in (("raft", {}), ("craft", dict(tally="collective")),
                       ("crossword", dict(tally="collective"))):
        jk, tk = _kernels(proto, cfg, g=2)
        assert tk.broadcast_lanes == jk.broadcast_lanes
        assert tk.TALLY_LANES == jk.TALLY_LANES
        assert tk.DURABLE_SCALARS == jk.DURABLE_SCALARS
        assert tk.DURABLE_WINDOWS == jk.DURABLE_WINDOWS
        assert tk.PHASES == jk.PHASES
        assert type(tk).name == type(jk).name


@pytest.mark.parametrize("proto", ["raft", "craft"])
def test_restore_durable_matches_jax_across_terms(proto):
    """The warm-start leader (replica 0) restoring a record of the
    warm-start term and of a later term whose vote went to replica 1:
    every leaf equals the JAX kernel's.  Both kernels keep the boot
    leader flag in the later term too, so a restarted replica 0 leads a
    term replica 1 won (the open fault in ROADMAP Queue 3); this pins
    the shared behaviour until both packages are repaired together."""
    jk, tk = _kernels(proto, {})
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    base = {k: np.asarray(jeng._boot[k][1, 0]).tolist()
            for k in jk.DURABLE_SCALARS + jk.DURABLE_WINDOWS}
    for term in (1, 2):
        rec = dict(base, term=term, voted_for=0 if term == 1 else 1)
        jst, tst = dict(jeng._boot), dict(teng._boot)
        jk.restore_durable(jst, 1, 0, rec, floor=0)
        tk.restore_durable(tst, 1, 0, rec, floor=0)
        tn = to_numpy(tst)
        assert bool(tn["is_leader"][1, 0])
        assert int(tn["term"][1, 0]) == term
        for k in jst:
            np.testing.assert_array_equal(tn[k], np.asarray(jst[k]),
                                          err_msg=k)
