"""The port's lockstep engine against the JAX engine, exactly.

Both engines start from the same state (the JAX boot state carried across
through ``summerset_tpu_torch.convert``) and run the same windows of
per-tick inputs: proposals every tick, a paused replica mid-window, a
durable device reset in window 1 (the recipe of
``tests/test_mesh_engine.py``'s ``_window_seq``), plus a leader crash or
a voluntary demotion where the case says so.  After every window the
sha256 digest of every state leaf, the collected per-tick effects and the
netstate must be equal, and leaf names, shapes and byte widths must
match.
"""

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


def _run_both(name):
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_digests_equal_jax(name):
    jd, td, final = _run_both(name)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(tk, mesh=object(), device="cpu")
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
