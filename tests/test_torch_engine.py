"""The port's lockstep engine against the JAX engine, exactly.

Both engines start from the same state (the JAX boot state carried across
through ``summerset_tpu_torch.convert``) and run the same windows of
per-tick inputs: proposals every tick, a paused replica mid-window, a
durable device reset in window 1 (the recipe of
``tests/test_mesh_engine.py``'s ``_window_seq``), plus a leader crash or
a voluntary demotion where the case says so.  After every window the
sha256 digest of every state leaf, the collected per-tick effects and the
netstate must be equal, and leaf names, shapes and byte widths must
match, against the unpatched JAX engine.  The one exception is where the
port's device reset departs from the reference: it empties a
MultiPaxos-family vote run that starts above the rewound commit bar
(ROADMAP Queue 3).  In the cases where that rule fires, the windows
from the reset on are held against the JAX engine run under
``port_reset_rule`` instead, and the reference stall the rule repairs
is pinned by a JAX-alone test.
"""

import contextlib
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summerset_tpu.core import Engine as JEngine
from summerset_tpu.core import NetConfig as JNet
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.multipaxos import ReplicaConfigMultiPaxos as JMP
from summerset_tpu.protocols.rspaxos import ReplicaConfigRSPaxos as JRS
from summerset_tpu_torch.convert import to_numpy, to_torch
from summerset_tpu_torch.core import Engine as TEngine
from summerset_tpu_torch.core import NetConfig as TNet
from summerset_tpu_torch.core.engine import reset_durable_rows
from summerset_tpu_torch.entry import entry
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.multipaxos import ReplicaConfigMultiPaxos as TMP
from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos as TRS

G, R, W, P = 8, 5, 32, 4
TICKS = 16      # per window


@contextlib.contextmanager
def port_reset_rule():
    """While JAX engines are built and traced, their device reset
    (``summerset_tpu.core.engine.reset_durable_rows``) follows the port's
    rule for the MultiPaxos family (``MultiPaxosKernel.reset_rows``): a
    rebuilt row whose vote run starts above its rewound commit bar gets
    the run emptied there.  Everything else of the reference is
    unchanged, so the gates still compare every other leaf."""
    import summerset_tpu.core.engine as jengine
    from summerset_tpu.protocols.multipaxos import MultiPaxosKernel

    orig = jengine.reset_durable_rows

    def reset(kernel, state, mask, boot=None):
        st = orig(kernel, state, mask, boot)
        if isinstance(kernel, MultiPaxosKernel):
            floor = st["commit_bar"]
            above = mask & (st["vote_from"] > floor)
            st = dict(st, **{k: jnp.where(above, floor, st[k])
                             for k in ("vote_from", "vote_bar", "dur_bar")})
        return st

    jengine.reset_durable_rows = reset
    try:
        yield
    finally:
        jengine.reset_durable_rows = orig
WINDOWS = 3

JITTER = dict(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
              max_delay_ticks=3)
FAST = dict(hear_timeout_lo=5, hear_timeout_hi=9)
# leases need hear_timeout_lo > leader_lease_len > lease_margin > max delay
LEASES = dict(leader_leases=True, leader_lease_len=8, lease_margin=4,
              hear_timeout_lo=10, hear_timeout_hi=14)

# name -> (protocol, config kwargs, net kwargs, schedule)
CASES = {
    "multipaxos-pairwise": ("multipaxos", {}, {}, ""),
    "multipaxos-collective-jitter-leases-demote": (
        "multipaxos",
        dict(tally="collective", **LEASES), JITTER, "demote"),
    "rspaxos-ft1": ("rspaxos", dict(fault_tolerance=1), {}, ""),
    "rspaxos-ft1-drops-jitter": ("rspaxos", dict(fault_tolerance=1),
                                 JITTER, ""),
    "rspaxos-ft1-leader-crash": ("rspaxos", dict(fault_tolerance=1, **FAST),
                                 {}, "crash"),
    "rspaxos-ft1-collective-crash-jitter": (
        "rspaxos", dict(fault_tolerance=1, tally="collective", **FAST),
        JITTER, "crash"),
}


def _kernels(proto, cfg):
    cfg = dict(max_proposals_per_tick=P, **cfg)
    if proto == "multipaxos":
        return (jmake(proto, G, R, W, JMP(**cfg)),
                tmake(proto, G, R, W, TMP(**cfg), device="cpu"))
    return (jmake(proto, G, R, W, JRS(**cfg)),
            tmake(proto, G, R, W, TRS(**cfg), device="cpu"))


def _window_seq(w, schedule):
    """One window's per-tick inputs as numpy arrays: proposals every
    tick, replica 1 paused at tick 3, a durable reset of replica 1 in
    window 1; ``crash`` kills the leader (replica 0) from absolute tick
    10 on, ``demote`` asks it to step down in window 1."""
    t = np.arange(TICKS, dtype=np.int32)
    alive = np.ones((TICKS, G, R), bool)
    alive[3, :, 1] = False
    reset = np.zeros((TICKS, G, R), bool)
    if w == 1:
        reset[5, :, 1] = True
    if schedule == "crash":
        abs_t = w * TICKS + t
        alive[abs_t >= 10, :, 0] = False
    seq = {
        "n_proposals": np.full((TICKS, G), P, np.int32),
        "value_base": np.broadcast_to(
            ((w * TICKS + t) * P)[:, None], (TICKS, G)).astype(np.int32),
        "alive": alive,
        "reset": reset,
    }
    if schedule == "demote":
        demote = np.zeros((TICKS, G, R), bool)
        if w == 1:
            demote[2:4, :, 0] = True
        seq["demote"] = demote
    return seq


def _digest_window(state, netstate, fx):
    """sha256 over every state leaf + the stacked effects + the netstate,
    each leaf with its name, dtype and shape."""
    h = hashlib.sha256()

    def leaf(name, a):
        a = np.asarray(a)
        h.update(f"{name}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())

    for k in sorted(state):
        leaf(k, state[k])
    leaf("fx.commit_bar", fx["commit_bar"])
    leaf("fx.exec_bar", fx["exec_bar"])
    for k in sorted(fx["extra"]):
        leaf(f"fx.{k}", fx["extra"][k])
    for k in sorted(netstate):
        if k == "bufs":
            for b in sorted(netstate["bufs"]):
                leaf(f"bufs.{b}", netstate["bufs"][b])
        else:
            leaf(k, netstate[k])
    return h.hexdigest()


def _signature(state):
    return {k: (np.asarray(v).dtype.str, np.asarray(v).shape)
            for k, v in state.items()}


def _common_start(jeng, teng):
    """The JAX boot state (strongly typed) and the same state on the port."""
    js, jns = jeng.init()
    np_state = {k: np.asarray(v) for k, v in js.items()}
    np_net = {k: ({b: np.asarray(x) for b, x in v.items()}
                  if isinstance(v, dict) else np.asarray(v))
              for k, v in jns.items()}
    tstate, tnet = teng.init()
    # the port boots the same state by itself ...
    assert _signature(to_numpy(tstate)) == _signature(np_state)
    for k in np_state:
        np.testing.assert_array_equal(to_numpy(tstate)[k], np_state[k])
    # ... and both engines start from the one carried across
    jstart = (jax.tree.map(jnp.asarray, np_state),
              jax.tree.map(jnp.asarray, np_net))
    return jstart, (to_torch(np_state, "cpu"), to_torch(np_net, "cpu"))


def _run_both(name, rule):
    """Both engines through the case's windows; the JAX engine under
    ``port_reset_rule`` if ``rule``, else the unpatched reference."""
    with port_reset_rule() if rule else contextlib.nullcontext():
        return _run_both_windows(name)


def _run_both_windows(name):
    proto, cfg, net, schedule = CASES[name]
    jk, tk = _kernels(proto, cfg)
    jeng = JEngine(jk, netcfg=JNet(**net), seed=7)
    teng = TEngine(tk, netcfg=TNet(**net), seed=7, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    jd, td = [], []
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
    return jd, td, to_numpy(ts)


#: the cases whose window-1 durable reset leaves replica 1 a vote run
#: above its rewound commit bar: the port's device-reset rule fires there
RESET_RULE_CASES = ("rspaxos-ft1-collective-crash-jitter",
                    "rspaxos-ft1-leader-crash")


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_digests_equal_jax(name):
    """Every window's digests equal the unpatched JAX engine's, except
    from the reset window on in ``RESET_RULE_CASES``: there the port's
    rule fires, the digests differ from the reference's, and they equal
    those of the JAX engine run under ``port_reset_rule`` in every
    window."""
    jd, td, final = _run_both(name, rule=False)
    if name in RESET_RULE_CASES:
        assert td[0] == jd[0]
        assert td[1] != jd[1]
        jd, td, final = _run_both(name, rule=True)
    assert td == jd
    assert int(final["commit_bar"].max()) > 0, "nothing committed"
    schedule = CASES[name][3]
    if schedule:
        # the failover ran: someone campaigned (the prepare-reply path)
        from summerset_tpu_torch.core.telemetry import LANE_IDX

        assert int(final["telem"][..., LANE_IDX["elections"]].sum()) > 0
    if schedule == "crash":
        assert (final["leader"][:, 1:] != 0).all()


def test_run_synthetic_final_state():
    cfg = dict(max_proposals_per_tick=8, chunk_size=16,
               exec_follows_commit=False)
    jk = jmake("multipaxos", G, R, W, JMP(**cfg))
    tk = tmake("multipaxos", G, R, W, TMP(**cfg), device="cpu")
    jeng, teng = JEngine(jk), TEngine(tk, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    js, jns = jeng.run_synthetic(js, jns, 24, 8)
    ts, tns = teng.run_synthetic(ts, tns, 24, 8)
    fx = {"commit_bar": np.zeros(1), "exec_bar": np.zeros(1), "extra": {}}
    assert _digest_window(to_numpy(ts), to_numpy(tns), fx) == \
        _digest_window(js, jns, fx)
    assert int(ts["commit_bar"].max()) > 0


def test_reset_and_restore_durable_match_jax():
    jk, tk = _kernels("rspaxos", dict(fault_tolerance=1))
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    seq = _window_seq(0, "")
    js, jns, _ = jeng.run_ticks(
        js, jns, {k: jnp.asarray(v) for k, v in seq.items()})
    ts, tns, _ = teng.run_ticks(ts, tns, seq)
    from summerset_tpu.core.engine import reset_durable_rows as jreset

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


@pytest.mark.parametrize("proto", ["multipaxos", "rspaxos"])
def test_restore_durable_empties_a_run_above_the_floor(proto):
    """A logged vote run that starts above the restored floor: the JAX
    kernel keeps it (the follower then never commits again at that
    ballot; ROADMAP Queue 3), the port brings it back empty at the floor
    (``vote_from`` = ``vote_bar`` = ``dur_bar`` = floor).  Every other
    leaf equals the JAX restore; a run reaching the floor is restored
    as in JAX."""
    jk, tk = _kernels(proto, dict(fault_tolerance=1)
                      if proto == "rspaxos" else {})
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    for vfrom, floor in ((9, 4), (4, 4), (2, 4)):
        bal = 2 * 256 + 1
        rec = {"bal_max": bal, "vote_bal": bal, "vote_from": vfrom,
               "vote_bar": 12, "win_abs": list(range(W)),
               "win_bal": [bal] * 12 + [0] * (W - 12),
               "win_val": rng.integers(0, 1 << 20, W).tolist()}
        for k in jk.DURABLE_SCALARS + jk.DURABLE_WINDOWS:
            rec.setdefault(k, np.asarray(jeng._boot[k][1, 2]).tolist())
        jst, tst = dict(jeng._boot), dict(teng._boot)
        jk.restore_durable(jst, 1, 2, rec, floor=floor)
        tk.restore_durable(tst, 1, 2, rec, floor=floor)
        tn = to_numpy(tst)
        empty = vfrom > floor
        for k in jst:
            want = np.asarray(jst[k]).copy()
            if empty and k in ("vote_from", "vote_bar", "dur_bar"):
                assert want[1, 2] > floor, k
                want[1, 2] = floor
            np.testing.assert_array_equal(tn[k], want, err_msg=k)


def test_lease_margin_refusal_and_unported_paths():
    for margin, delay in ((3, 3), (2, 3), (1, 1)):
        cfg = dict(max_proposals_per_tick=P, leader_leases=True,
                   lease_margin=margin)
        net = dict(delay_ticks=1, max_delay_ticks=delay)
        with pytest.raises(ValueError, match="lease_margin"):
            JEngine(jmake("multipaxos", G, R, W, JMP(**cfg)),
                    netcfg=JNet(**net))
        with pytest.raises(ValueError, match="lease_margin"):
            TEngine(tmake("multipaxos", G, R, W, TMP(**cfg), device="cpu"),
                    netcfg=TNet(**net), device="cpu")
    ok = TMP(max_proposals_per_tick=P, leader_leases=True, lease_margin=4)
    TEngine(tmake("multipaxos", G, R, W, ok, device="cpu"),
            netcfg=TNet(delay_ticks=1, max_delay_ticks=3), device="cpu")
    tk = tmake("multipaxos", G, R, W, TMP(max_proposals_per_tick=P),
               device="cpu")
    # the mesh is ported: a Mesh is accepted, anything else refused
    from summerset_tpu_torch.core.sharding import mesh_for

    with pytest.raises(TypeError, match="Mesh"):
        TEngine(tk, mesh=object(), device="cpu")
    eng = TEngine(tk, mesh=mesh_for(2, 1, ["cpu"] * 2, repeat=True),
                  device="cpu")
    assert len(eng.init()[0].shards) == 2
    # every protocol of the JAX package is ported, EPaxos last
    for name in ("epaxos", "EPaxos"):
        k = tmake(name, G, R, W, device="cpu")
        assert type(k).name == "EPaxos" and k.device.type == "cpu"
    with pytest.raises(ValueError, match="unrecognized"):
        tmake("nope", G, R, W, device="cpu")


def test_entry_matches_graft_entry_on_cpu():
    """The port's flagship tick against ``__graft_entry__.entry``: the
    same boot state and the same three ticks, leaf for leaf."""
    import __graft_entry__

    jfn, (js, jns, jin) = __graft_entry__.entry()
    jfn = jax.jit(jfn)
    fn, (ts, tns, tin) = entry(device="cpu")
    assert tuple(ts["commit_bar"].shape) == (1024, 5)
    none = {"commit_bar": np.zeros(1), "exec_bar": np.zeros(1), "extra": {}}
    for _ in range(3):
        js, jns, jfx = jfn(js, jns, jin)
        ts, tns, tfx = fn(ts, tns, tin)
        assert _digest_window(to_numpy(ts), to_numpy(tns), none) == \
            _digest_window(js, jns, none)
        for k in jfx.extra:
            np.testing.assert_array_equal(tfx.extra[k].numpy(),
                                          np.asarray(jfx.extra[k]), err_msg=k)
    assert int(ts["next_slot"][:, 0].min()) == 48
    assert int(ts["commit_bar"].max()) == 16


#: the nemesis plan of ``chip_smoke.py`` phase 21 (a) at a small shape:
#: replica 1 of a saturated RSPaxos group is reset by the device plane
#: while its vote run starts above its rewound commit bar
STALL = dict(G=1, W=32, P=4, plan_ticks=160, heal_ticks=200, win=40)
STALL_CLASSES = ("crash", "device_reset", "pause", "partition", "isolate",
                 "one_way", "drop", "clock_skew")


def _stall_seq(masks, lo, hi, P):
    t = np.arange(lo, hi, dtype=np.int32)
    G = STALL["G"]
    seq = {"n_proposals": np.full((hi - lo, G), P, np.int32),
           "value_base": np.broadcast_to((t * P)[:, None],
                                         (hi - lo, G)).astype(np.int32),
           "exec_floor": np.full((hi - lo, G, R), 1 << 30, np.int32)}
    if masks is not None:
        seq.update({k: np.asarray(v)[lo:hi] for k, v in masks.items()})
    return seq


def _stall_run(port):
    """The plan and its heal through one engine; the final commit bars."""
    from summerset_tpu.host.nemesis import FaultPlan

    sc = STALL
    cfg = dict(max_proposals_per_tick=sc["P"], chunk_size=2 * sc["P"],
               exec_follows_commit=False, fault_tolerance=1)
    masks = FaultPlan.generate(11, R, sc["plan_ticks"],
                               classes=STALL_CLASSES).compile_device(sc["G"])
    if port:
        eng = TEngine(tmake("rspaxos", sc["G"], R, sc["W"], TRS(**cfg),
                            device="cpu"), device="cpu")
    else:
        eng = JEngine(jmake("rspaxos", sc["G"], R, sc["W"], JRS(**cfg)))
    st, ns = eng.init()
    for lo in range(0, sc["plan_ticks"] + sc["heal_ticks"], sc["win"]):
        m = masks if lo < sc["plan_ticks"] else None
        seq = _stall_seq(m, lo, lo + sc["win"], sc["P"])
        if not port:
            seq = {k: jnp.asarray(v) for k, v in seq.items()}
        st, ns, _ = eng.run_ticks(st, ns, seq)
    return np.asarray(to_numpy(st)["commit_bar"] if port
                      else st["commit_bar"])


def test_reference_device_reset_stalls_a_follower():
    """The JAX engine alone: after the plan and a 200-tick fault-free
    heal, the reset replica 1 still has commit bar 0 while its peers
    committed thousands of slots (the reference defect)."""
    cb = _stall_run(port=False)
    assert cb[0, 1] == 0, cb
    assert (np.delete(cb[0], 1) > 1000).all(), cb


def test_device_reset_follower_catches_up_in_the_port():
    """The port under the same plan: the reset replica catches up, every
    replica within 4P of the leader's commit bar after the heal."""
    cb = _stall_run(port=True)
    assert (cb.max(axis=1) - cb.min(axis=1) <= 4 * STALL["P"]).all(), cb
    assert cb.min() > 1000, cb


@pytest.mark.parametrize("proto", ["multipaxos", "rspaxos"])
def test_device_reset_empties_a_run_above_the_floor(proto):
    """``reset_durable_rows`` on a state whose reset rows hold a vote run
    starting above the rewound commit bar (row (1, 2)) or at it (row
    (3, 2)): the port empties the first run at the commit bar
    (``vote_from`` = ``vote_bar`` = ``dur_bar``); every other value
    equals the JAX reset's."""
    from summerset_tpu.core.engine import reset_durable_rows as jreset

    jk, tk = _kernels(proto, dict(fault_tolerance=1)
                      if proto == "rspaxos" else {})
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    (js, _jns), (ts, _tns) = _common_start(jeng, teng)
    base = {k: np.asarray(v).copy() for k, v in js.items()}
    for g, vfrom in ((1, 9), (3, 0)):
        base["vote_from"][g, 2] = vfrom
        base["vote_bar"][g, 2] = 12
        base["commit_bar"][g, 2] = 7
    mask = np.zeros((G, R), bool)
    mask[[1, 3], 2] = True
    jr = {k: np.asarray(v) for k, v in jreset(
        jk, {k: jnp.asarray(v) for k, v in base.items()},
        jnp.asarray(mask), jeng._boot).items()}
    tr = to_numpy(reset_durable_rows(
        tk, to_torch(base, "cpu"), torch.from_numpy(mask), teng._boot))
    floor = int(np.asarray(jeng._boot["commit_bar"])[1, 2])
    assert jr["vote_from"][1, 2] == 9 and jr["vote_bar"][1, 2] == 12
    for k in jr:
        want = jr[k].copy()
        if k in ("vote_from", "vote_bar", "dur_bar"):
            want[1, 2] = floor
        np.testing.assert_array_equal(tr[k], want, err_msg=k)
