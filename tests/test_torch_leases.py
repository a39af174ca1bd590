"""The port's QuorumLeases and Bodega kernels against the JAX package,
exactly, and the JAX lease-safety properties run on the port alone.

Digest cases follow ``tests/test_torch_raft.py``: both engines start from
the JAX boot state carried across through ``summerset_tpu_torch.convert``
and run three windows of the same per-tick inputs (proposals every tick,
replica 1 paused at tick 3, a durable reset of replica 1 in window 1, plus
the case's conf inputs and schedule).  After every window the sha256
digest of every state leaf, the stacked effects and the netstate must be
equal, and so must the state signatures.  Tolerance: none, every compared
value is an integer or a bool.  Each kernel has one jittered case, so its
bool broadcast lane (``bw_cfg``, ``bw_noop``) crosses the D=3 delay line.

The property tests are copies of ``tests/test_quorum_leases.py`` and
``tests/test_bodega.py`` cases on the port (``device="cpu"``), with the
same shapes, seeds, schedules and assertions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smr_helpers import check_agreement, committed_values
from summerset_tpu.core import Engine as JEngine
from summerset_tpu.core import NetConfig as JNet
from summerset_tpu.core.engine import reset_durable_rows as jreset
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.bodega import ReplicaConfigBodega as JBO
from summerset_tpu.protocols.quorum_leases import (
    ReplicaConfigQuorumLeases as JQL,
)
from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import ControlInputs
from summerset_tpu_torch.core import Engine as TEngine
from summerset_tpu_torch.core import NetConfig as TNet
from summerset_tpu_torch.core.engine import reset_durable_rows
from summerset_tpu_torch.core.telemetry import LANE_IDX
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.bodega import ReplicaConfigBodega as TBO
from summerset_tpu_torch.protocols.quorum_leases import (
    ReplicaConfigQuorumLeases as TQL,
)
from test_torch_engine import _common_start, _digest_window, _signature

G, R, W, P = 8, 5, 32, 4
TICKS = 24      # per window
WINDOWS = 3

JITTER = dict(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
              max_delay_ticks=3)
CONFIGS = {"quorumleases": (JQL, TQL), "bodega": (JBO, TBO)}
RESP = 0b00110          # responders {1, 2}

# name -> (protocol, config kwargs, net kwargs, schedule)
CASES = {
    "ql-pairwise-default": ("quorumleases", {}, {}, ""),
    "ql-conf-via-log": ("quorumleases", {}, {}, "conf"),
    "ql-collective-jitter-drops": (
        "quorumleases", dict(tally="collective"), JITTER, "conf"),
    "ql-paused-responder": ("quorumleases", {}, {}, "conf-pause2"),
    "bodega-roster": ("bodega", {}, {}, "roster"),
    "bodega-per-bucket": ("bodega", {}, {}, "bucket3"),
    "bodega-leader-pause": ("bodega", dict(conf_timeout=12), {}, "pause0"),
    "bodega-collective-jitter-drops": (
        "bodega", dict(tally="collective"), JITTER, "roster"),
}

PAUSE_FROM = 30         # absolute tick the paused replica stops at


def _kernels(proto, cfg, g=G, r=R, w=W):
    jcfg, tcfg = CONFIGS[proto]
    cfg = dict(max_proposals_per_tick=P, **cfg)
    return (jmake(proto, g, r, w, jcfg(**cfg)),
            tmake(proto, g, r, w, tcfg(**cfg), device="cpu"))


def _window_seq(w, schedule):
    """One window's per-tick inputs as numpy arrays."""
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
        "alive": alive,
        "reset": reset,
    }
    if schedule.startswith("conf"):
        seq["conf_target"] = np.full((TICKS, G), RESP, np.int32)
    if schedule == "conf-pause2":
        alive[abs_t >= PAUSE_FROM, :, 2] = False
    if schedule in ("roster", "bucket3"):
        seq["conf_init"] = np.where(abs_t == 0, 0, -1)[:, None].repeat(
            G, axis=1).astype(np.int32)
        seq["conf_leader_target"] = np.zeros((TICKS, G), np.int32)
        seq["conf_resp_target"] = np.full((TICKS, G), RESP, np.int32)
        seq["conf_bucket"] = np.full(
            (TICKS, G), 3 if schedule == "bucket3" else -1, np.int32)
    if schedule == "pause0":
        alive[abs_t >= PAUSE_FROM - 10, :, 0] = False
    return seq


def _run_both(name):
    proto, cfg, net, schedule = CASES[name]
    jk, tk = _kernels(proto, cfg)
    jeng = JEngine(jk, netcfg=JNet(**net), seed=7)
    teng = TEngine(tk, netcfg=TNet(**net), seed=7, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    jd, td, finals = [], [], []
    for w in range(WINDOWS):
        seq = _window_seq(w, schedule)
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
        finals.append((tsn, {k: v.numpy() for k, v in tfx.extra.items()},
                       tns))
    return jd, td, finals


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_digests_equal_jax(name):
    jd, td, finals = _run_both(name)
    assert td == jd
    final, fx, tns = finals[-1]
    assert int(final["commit_bar"].max()) > 0, "nothing committed"
    proto, _, net, schedule = CASES[name]
    if net:
        # the bool broadcast lane crossed the jittered D=3 line
        lane = "bw_cfg" if proto == "quorumleases" else "bw_noop"
        buf = tns["bufs"][lane]
        assert buf.dtype == torch.bool and buf.shape[0] == 3
    if schedule.startswith("conf"):
        # the conf was applied through the log, and leases were granted
        assert (final["conf_cur"] == RESP).all()
        assert int(final["telem"][..., LANE_IDX["grants"]].sum()) > 0
    if schedule == "conf" and not net:
        # responders 1 and 2 hold majority leases at the last tick ...
        assert fx["lease_held"][-1][:, [1, 2]].all()
        assert not fx["lease_held"][-1][:, [0, 3, 4]].any()
        # ... and only the leader reads under its leader lease
        assert fx["leader_read_ok"][-1][:, 0].all()
        assert not fx["leader_read_ok"][-1][:, 1:].any()
    if schedule == "conf-pause2":
        # the barrier held writes while responder 2's lease could be live,
        # then lifted once it lapsed: commits rose again
        st0 = finals[1][0]
        assert (final["commit_bar"][:, 0] > st0["commit_bar"][:, 0]).all()
    if schedule in ("roster", "bucket3"):
        assert (final["conf_bal"] > (1 << 8)).all()
        want = np.full(TBO().num_key_buckets, RESP)
        if schedule == "bucket3":
            want = np.where(np.arange(want.size) == 3, RESP, 0)
        assert (final["conf_resp"] == want).all()
        assert (final["lease_out"].max(axis=2) > 0).any()
    if schedule == "pause0":
        # a live replica staged or installed a filtered conf with a new
        # leader at a higher ballot, and the live side kept committing
        live = final["conf_bal"][:, 1:]
        assert (live > (1 << 8)).all()
        assert (final["conf_leader"][:, 1:] != 0).all()
        st0 = finals[0][0]
        assert (final["commit_bar"][:, 1:].max(axis=1)
                > st0["commit_bar"][:, 1:].max(axis=1)).all()


@pytest.mark.parametrize("proto,cfg", [
    ("quorumleases", dict(init_responders=RESP)),
    ("bodega", dict(init_responders=RESP)),
])
def test_reset_and_restore_durable_match_jax(proto, cfg):
    jk, tk = _kernels(proto, cfg)
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    seq = _window_seq(0, "conf" if proto == "quorumleases" else "roster")
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


@pytest.mark.parametrize("proto", sorted(CONFIGS))
def test_lease_margin_refusal(proto):
    """Both lease kernels are refused when ``lease_margin`` does not exceed
    the network's max one-way delay, by the JAX engine and the port's."""
    jcfg, tcfg = CONFIGS[proto]
    for margin, delay in ((3, 3), (2, 3), (1, 1), (4, 4)):
        cfg = dict(max_proposals_per_tick=P, lease_margin=margin)
        net = dict(delay_ticks=1, max_delay_ticks=delay)
        with pytest.raises(ValueError, match="lease_margin"):
            JEngine(jmake(proto, G, R, W, jcfg(**cfg)), netcfg=JNet(**net))
        with pytest.raises(ValueError, match="lease_margin"):
            TEngine(tmake(proto, G, R, W, tcfg(**cfg), device="cpu"),
                    netcfg=TNet(**net), device="cpu")
    ok = tcfg(max_proposals_per_tick=P, lease_margin=4)
    TEngine(tmake(proto, G, R, W, ok, device="cpu"),
            netcfg=TNet(delay_ticks=1, max_delay_ticks=3), device="cpu")
    # the base leader-lease flag is refused: each kernel has its own plane
    with pytest.raises(ValueError, match="leader_leases"):
        tmake(proto, G, R, W, tcfg(leader_leases=True), device="cpu")


# ------------------------------------------- lease safety, on the port alone
def _port(proto, g, r, w, p, seed=0, **kw):
    _, tcfg = CONFIGS[proto]
    k = tmake(proto, g, r, w, tcfg(max_proposals_per_tick=p, **kw),
              device="cpu")
    eng = TEngine(k, seed=seed, device="cpu")
    return eng, *eng.init()


def _np(state):
    return to_numpy(state)


def _run(eng, st, ns, ticks, n_prop, base_start=0, conf_target=None,
         conf=None, alive=None, link_up=None, collect=False):
    """``tests/smr_helpers.run_segment`` on the port, with the lease
    kernels' conf inputs: QuorumLeases' ``conf_target`` every tick, or a
    Bodega ``conf`` = (init replica, leader, responders, bucket) announced
    on the first tick."""
    g = eng.kernel.G
    p = eng.kernel.config.max_proposals_per_tick
    t = np.arange(ticks, dtype=np.int32)
    seq = {
        "n_proposals": np.full((ticks, g), n_prop, np.int32),
        "value_base": np.broadcast_to(((base_start + t) * p)[:, None],
                                      (ticks, g)).astype(np.int32),
    }
    if conf_target is not None:
        seq["conf_target"] = np.full((ticks, g), conf_target, np.int32)
    if conf is not None:
        init, lead, resp, bucket = conf
        seq["conf_init"] = np.where(t == 0, init, -1)[:, None].repeat(
            g, axis=1).astype(np.int32)
        seq["conf_leader_target"] = np.full((ticks, g), lead, np.int32)
        seq["conf_resp_target"] = np.full((ticks, g), resp, np.int32)
        seq["conf_bucket"] = np.full((ticks, g), bucket, np.int32)
    if alive is not None:
        a = torch.as_tensor(alive)
        seq["alive"] = a.expand((ticks,) + tuple(a.shape[-2:])) \
            if a.ndim == 2 else a
    if link_up is not None:
        seq["link_up"] = torch.as_tensor(link_up).expand(
            (ticks,) + tuple(link_up.shape))
    return eng.run_ticks(st, ns, seq, collect=collect)


def _down(g, r, *victims):
    alive = np.ones((g, r), bool)
    alive[:, list(victims)] = False
    return alive


def test_ql_dead_responder_stalls_writes_until_lease_expiry():
    """``test_quorum_leases.py::test_dead_responder_stalls_writes_until_
    lease_expiry`` on the port."""
    g, r, w, p = 2, 5, 48, 2
    eng, st, ns = _port("quorumleases", g, r, w, p, lease_len=16,
                        lease_margin=4, hear_timeout_lo=40,
                        hear_timeout_hi=70)
    st, ns, _ = _run(eng, st, ns, 30, p, conf_target=RESP)
    pre = _np(st)["commit_bar"][:, 0].copy()
    # kill responder 2: writes must stall while its lease may be live
    st, ns, _ = _run(eng, st, ns, 8, p, base_start=1000, conf_target=RESP,
                     alive=_down(g, r, 2))
    mid = _np(st)["commit_bar"][:, 0]
    assert (mid <= pre + 2 * p).all(), (pre, mid)
    # after lease_len + margin the barrier lifts and commits resume
    st, ns, _ = _run(eng, st, ns, 60, p, base_start=2000, conf_target=RESP,
                     alive=_down(g, r, 2))
    fin = _np(st)
    assert (fin["commit_bar"][:, 0] > mid + 10 * p).all(), (
        mid, fin["commit_bar"][:, 0])
    check_agreement(fin, g, r, w)


def test_ql_minority_partitioned_responder_loses_lease():
    """``test_quorum_leases.py::test_minority_partitioned_responder_loses_
    lease`` on the port: partition {0, 1} | {2, 3, 4} for 200 ticks."""
    g, r, w, p = 2, 5, 48, 2
    eng, st, ns = _port("quorumleases", g, r, w, p, seed=3, lease_len=12,
                        lease_margin=4, hear_timeout_lo=30,
                        hear_timeout_hi=50)
    st, ns, _ = _run(eng, st, ns, 30, p, conf_target=RESP)
    link = ControlInputs.split_links(g, r, (0, 1), device="cpu")
    st, ns, fx = _run(eng, st, ns, 200, p, base_start=1000,
                      conf_target=RESP, link_up=link, collect=True)
    fin = _np(st)
    lease = fx.extra["lease_held"][-1].numpy()
    assert not lease[:, 1].any(), lease      # minority responder lost it
    assert (fin["commit_bar"][:, 2:].max(axis=1) > 30).all()
    assert lease[:, 2].all(), lease          # majority responder kept it
    check_agreement(fin, g, r, w)


def test_ql_local_reads_stay_safe_under_skew():
    """``test_quorum_leases.py::test_local_reads_stay_safe_under_skew`` on
    the port: responder 2's clock at half rate for 160 ticks; whenever it
    could serve every bucket locally, no replica has committed a slot it
    has not executed."""
    g, r, w, p = 2, 5, 48, 2
    eng, st, ns = _port("quorumleases", g, r, w, p, seed=5, lease_len=12,
                        lease_margin=4, num_key_buckets=8,
                        hear_timeout_lo=40, hear_timeout_hi=70)
    st, ns, _ = _run(eng, st, ns, 30, p, conf_target=RESP)
    pre = int(_np(st)["commit_bar"].max())
    T = 160
    skew = ControlInputs.skew_alive(g, r, T, {2: 0.5}, device="cpu")
    st, ns, fx = _run(eng, st, ns, T, p, base_start=1000, conf_target=RESP,
                      alive=skew, collect=True)
    lease = fx.extra["lease_held"].numpy()          # [T, G, R]
    nloc = fx.extra["n_local_buckets"].numpy()
    cb, eb = fx.commit_bar.numpy(), fx.exec_bar.numpy()
    servable = lease[:, :, 2] & (nloc[:, :, 2] == 8)
    stale = servable & (cb.max(axis=2) > eb[:, :, 2])
    assert not stale.any(), np.nonzero(stale.any(axis=1))[0]
    assert servable.any()
    fin = _np(st)
    assert int(fin["commit_bar"].max()) > pre + 20
    check_agreement(fin, g, r, w)


def test_bodega_conf_install_waits_for_outgoing_leases():
    """``test_bodega.py::test_conf_install_waits_for_outgoing_leases`` on
    the port (3 replicas, long leases, a conf naming leader 1)."""
    g, r, w, p = 2, 3, 32, 2
    eng, st, ns = _port("bodega", g, r, w, p, lease_len=20, lease_margin=6,
                        grant_interval=4)
    st, ns, _ = _run(eng, st, ns, 12, p)
    st0 = _np(st)
    bal0 = st0["conf_bal"][0, 0]
    assert (st0["lease_out"].max(axis=2) > 0).any()
    st, ns, _ = _run(eng, st, ns, 3, p, base_start=100,
                     conf=(1, 1, 0b011, -1))
    mid = _np(st)
    # the new conf is installed (revoke round trips are fast) or pending
    assert ((mid["pend_bal"] > bal0) | (mid["conf_bal"] > bal0)).any()
    st, ns, _ = _run(eng, st, ns, 40, p, base_start=200)
    fin = _np(st)
    assert (fin["conf_bal"] > bal0).all()
    assert (fin["conf_leader"] == 1).all()
    check_agreement(fin, g, r, w)


def test_bodega_write_barrier_blocks_on_dead_responder_then_conf_heals():
    """``test_bodega.py::test_write_barrier_blocks_on_dead_responder_then_
    conf_heals`` on the port: responder 4 dies, writes stop (its ack is
    required), conf failover drops it from the roster, commits resume."""
    g, r, w, p = 2, 5, 64, 2
    eng, st, ns = _port("bodega", g, r, w, p, conf_timeout=12)
    resp = 0b11000  # responders {3, 4}
    st, ns, _ = _run(eng, st, ns, 40, p, conf=(0, 0, resp, -1))
    pre = _np(st)
    assert (pre["conf_resp"] == resp).all()
    pre_cb = pre["commit_bar"][:, 0].copy()
    assert (pre_cb > 0).all()
    # short window: the barrier blocks before failover kicks in
    st, ns, _ = _run(eng, st, ns, 10, p, base_start=1000,
                     alive=_down(g, r, 4))
    mid = _np(st)
    assert (mid["commit_bar"][:, 0] <= pre_cb + 3 * p).all()
    # long window: conf failover drops 4, commits resume
    st, ns, _ = _run(eng, st, ns, 150, p, base_start=2000,
                     alive=_down(g, r, 4))
    post = _np(st)
    assert (post["conf_resp"][:, 0] & (1 << 4) == 0).all()
    assert (post["commit_bar"][:, 0] > mid["commit_bar"][:, 0] + 5).all()
    check_agreement(post, g, r, w)


def test_bodega_leader_death_conf_takeover():
    """``test_bodega.py::test_leader_death_conf_takeover`` on the port:
    the conf leader dies; a live replica volunteers through a filtered
    conf at a higher ballot, steps up, and committed values survive."""
    g, r, w, p = 2, 5, 64, 2
    eng, st, ns = _port("bodega", g, r, w, p, seed=7, conf_timeout=12)
    st, ns, _ = _run(eng, st, ns, 30, p)
    pre = _np(st)
    pre_committed = [committed_values(pre, gi, 1, w) for gi in range(g)]
    st, ns, _ = _run(eng, st, ns, 300, p, base_start=1000,
                     alive=_down(g, r, 0))
    post = _np(st)
    assert (post["conf_leader"][:, 1:] >= 1).all(), post["conf_leader"]
    assert (post["commit_bar"][:, 1:].max(axis=1)
            > pre["commit_bar"][:, 1:].max(axis=1)).all()
    for gi in range(g):
        for ri in range(1, r):
            if int(post["leader"][gi, ri]) == ri:
                vals = committed_values(post, gi, ri, w)
                for slot, v in pre_committed[gi].items():
                    if slot in vals:
                        assert vals[slot] == v
    check_agreement(post, g, r, w)
