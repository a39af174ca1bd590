"""The port's nemesis plane (``summerset_tpu_torch/host/nemesis.py``)
against the JAX package's, and a live soak of a port cluster.

Plans: for every seed and class set, ``timeline()``, ``digest()``,
``host_actions()`` and the compiled device masks are byte-identical to
the JAX ``FaultPlan``'s.  The device plane: one compiled plan drives the
JAX engine and the port's through the same ticks, and the sha256 digest
of every state leaf, the stacked effects and the netstate is equal after
every window (no tolerance: every value is an integer or a bool), on
MultiPaxos, RSPaxos and Raft.  The live soak plays one seeded plan
against a port cluster through ``NemesisRunner`` and checks bounded
recovery, a linearizable history and only injected crashes; its
3-seed x 3-protocol matrix is marked ``slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smr_helpers import check_agreement
from summerset_tpu.core import Engine as JEngine
from summerset_tpu.host import nemesis as jnem
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.multipaxos import ReplicaConfigMultiPaxos as JMP
from summerset_tpu.protocols.raft import ReplicaConfigRaft as JRA
from summerset_tpu.protocols.rspaxos import ReplicaConfigRSPaxos as JRS
from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import Engine as TEngine
from summerset_tpu_torch.host import nemesis as tnem
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.multipaxos import (
    ReplicaConfigMultiPaxos as TMP,
)
from summerset_tpu_torch.protocols.raft import ReplicaConfigRaft as TRA
from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos as TRS
from test_torch_engine import (
    _common_start, _digest_window, _signature, port_reset_rule,
)

torch.set_num_threads(1)

# the class sets of tests/test_nemesis.py and scripts/nemesis_soak.py
DEVICE_SOAK = ("crash", "device_reset", "pause", "partition", "isolate",
               "one_way", "drop")
LIVE_SOAK = ("crash", "device_reset", "partition", "pause", "drop",
             "wal_torn", "take_snapshot")
CLASS_SETS = {
    "all": jnem.ALL_CLASSES,
    "device-soak": DEVICE_SOAK,
    "device-soak-skew": DEVICE_SOAK + ("clock_skew",),
    "live-soak": LIVE_SOAK,
    "reset-partition": ("device_reset", "partition"),
    "clock-skew": ("clock_skew",),
    "soak-matrix": ("crash", "partition", "isolate", "one_way", "drop",
                    "pause", "wal_torn", "wal_fsync", "clock_skew",
                    "device_reset", "conf_change", "take_snapshot",
                    "range_change"),
}
SEEDS = (1, 2, 3, 11, 21)


def _plans(seed, classes, population, ticks):
    return (jnem.FaultPlan.generate(seed, population, ticks, classes=classes),
            tnem.FaultPlan.generate(seed, population, ticks, classes=classes))


def event_tuple(ev):
    return (ev.tick, ev.kind, ev.targets, ev.duration, ev.arg)


def test_class_tables_match_jax():
    assert tnem.ALL_CLASSES == jnem.ALL_CLASSES
    assert tnem.HOST_ONLY == jnem.HOST_ONLY
    assert tnem.INSTANT == jnem.INSTANT
    assert tnem.SLOW_PEER_BW == jnem.SLOW_PEER_BW


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cset", sorted(CLASS_SETS))
def test_plans_equal_jax(cset, seed):
    """``timeline()``, ``digest()`` and ``host_actions()`` byte for byte,
    at the live soak's (3 replicas, 48 ticks), the matrix's (3, 120) and
    the device tests' (5, 300) shapes."""
    for population, ticks in ((3, 48), (3, 120), (5, 300)):
        j, t = _plans(seed, CLASS_SETS[cset], population, ticks)
        assert t.timeline() == j.timeline()
        assert t.digest() == j.digest()
        assert t.host_actions() == j.host_actions()
        assert [event_tuple(e) for e in t.events] == \
            [event_tuple(e) for e in j.events]


@pytest.mark.parametrize("seed", SEEDS)
def test_failslow_and_proxy_crash_plans_equal_jax(seed):
    for kind in ("slow_disk", "slow_peer", "mem_pressure"):
        for arg in (None, 7.0):
            j = jnem.FaultPlan.failslow(kind, seed, 3, 80, arg=arg)
            t = tnem.FaultPlan.failslow(kind, seed, 3, 80, arg=arg)
            assert t.timeline() == j.timeline()
            assert t.digest() == j.digest()
            assert t.host_actions() == j.host_actions()
    for at in (None, 9):
        j = jnem.FaultPlan.proxy_crash(seed, 3, 60, proxies=2, at=at)
        t = tnem.FaultPlan.proxy_crash(seed, 3, 60, proxies=2, at=at)
        assert t.timeline() == j.timeline()
        assert t.host_actions() == j.host_actions()
    with pytest.raises(ValueError):
        tnem.FaultPlan.failslow("crash", seed, 3, 80)
    with pytest.raises(ValueError):
        tnem.FaultPlan.generate(seed, 3, 50, classes=("nope",))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_compiled_masks_equal_jax(seed, G):
    """``compile_device(G)`` gives the JAX package's masks (bool tensors
    on the asked device, here the CPU)."""
    for cset in ("all", "device-soak-skew", "reset-partition"):
        j, t = _plans(seed, CLASS_SETS[cset], 5, 160)
        jm = j.compile_device(G)
        tm = t.compile_device(G, device="cpu")
        assert sorted(tm) == sorted(jm) == ["alive", "link_up", "reset"]
        for k in jm:
            assert tm[k].dtype == torch.bool and tm[k].device.type == "cpu"
            assert np.array_equal(tm[k].numpy(), jm[k]), (cset, k)


def test_compile_device_follows_the_device_rule():
    plan = tnem.FaultPlan.generate(1, 3, 40)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        plan.compile_device(2)


def test_the_port_plan_names_no_jax_module():
    import sys

    mod = sys.modules[tnem.FaultPlan.__module__]
    assert mod.__name__ == "summerset_tpu_torch.host.nemesis"
    assert "summerset_tpu." not in repr(vars(tnem.FaultPlan))
    for name in ("ControlInputs", "GenericEndpoint", "CtrlRequest"):
        obj = getattr(mod, name, None)
        if obj is not None:
            assert obj.__module__.startswith("summerset_tpu_torch.")
    assert tnem.CtrlRequest.__module__ == "summerset_tpu_torch.host.messages"


# ------------------------------------------------------------ device plane
G, R, W = 3, 5, 32
PLAN_TICKS = 160
HEAL_TICKS = 200
WIN = 40                      # ticks per digested window
DEVICE_CLASSES = DEVICE_SOAK + ("clock_skew",)

PROTOCOLS = {
    "multipaxos": (JMP, TMP, {}),
    "rspaxos": (JRS, TRS, dict(fault_tolerance=1)),
    "raft": (JRA, TRA, {}),
}


def _window_inputs(masks, lo, hi, jax_side, P):
    t = np.arange(lo, hi, dtype=np.int32)
    seq = {
        "n_proposals": np.full((hi - lo, G), P, np.int32),
        "value_base": np.broadcast_to((t * P)[:, None],
                                      (hi - lo, G)).astype(np.int32),
    }
    if masks is not None:
        for k in ("alive", "link_up", "reset"):
            seq[k] = masks[k][lo:hi]
    if jax_side:
        return {k: jnp.asarray(np.asarray(v)) for k, v in seq.items()}
    return seq


def _digest(state, netstate, fx, port):
    if port:
        return _digest_window(
            to_numpy(state), to_numpy(netstate),
            {"commit_bar": fx.commit_bar.numpy(),
             "exec_bar": fx.exec_bar.numpy(),
             "extra": {k: v.numpy() for k, v in fx.extra.items()}})
    return _digest_window(state, netstate,
                          {"commit_bar": fx.commit_bar,
                           "exec_bar": fx.exec_bar, "extra": fx.extra})


#: the cases whose plan resets a follower while its vote run starts above
#: its rewound commit bar: the port's device-reset rule fires there
RESET_RULE_CASES = (("multipaxos", 11, 4),)


@pytest.mark.parametrize("seed,P", [(11, 2), (38, 2), (11, 4)])
@pytest.mark.parametrize("proto", sorted(PROTOCOLS))
def test_device_plane_digests_equal_jax(proto, seed, P):
    """A plan over the device classes and ``clock_skew`` (seed 11, the
    chip check's; seed 38, which adds drop and one_way), compiled for G=3
    by each package, drives both engines for 160 ticks and a 200-tick
    heal segment: every 40-tick window's digest equals the unpatched JAX
    engine's, agreement holds, every group commits, and after the heal
    every group's replicas sit within 4P commits of each other and above
    the faulted run's commit bar (``TestDevicePlaneSoak``).  In
    ``RESET_RULE_CASES`` (at P=4 seed 11 resets a MultiPaxos follower
    whose vote run starts above its rewound commit bar) the digests equal
    the reference's up to the first device reset and differ after it,
    where the port's rule fires; there they equal those of the JAX engine
    run under ``port_reset_rule`` in every window."""
    td, jd = _device_plane(proto, seed, P)
    if (proto, seed, P) in RESET_RULE_CASES:
        plan = tnem.FaultPlan.generate(seed, R, PLAN_TICKS,
                                       classes=DEVICE_CLASSES)
        first = min(e.tick for e in plan.events
                    if e.kind == "device_reset") // WIN
        assert td[:first] == jd[:first]
        assert td != jd
        with port_reset_rule():
            td, jd = _device_plane(proto, seed, P)
    assert td == jd


def _device_plane(proto, seed, P):
    """Both engines through the plan and the heal; the port's final
    state is checked here, and the per-window digests (port, JAX) are
    returned."""
    jcfg, tcfg, extra = PROTOCOLS[proto]
    jk = jmake(proto, G, R, W, jcfg(max_proposals_per_tick=P, **extra))
    tk = tmake(proto, G, R, W, tcfg(max_proposals_per_tick=P, **extra),
               device="cpu")
    jeng, teng = JEngine(jk, seed=5), TEngine(tk, seed=5, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    jplan, tplan = _plans(seed, DEVICE_CLASSES, R, PLAN_TICKS)
    assert tplan.digest() == jplan.digest()
    jm = jplan.compile_device(G)
    tm = tplan.compile_device(G, device="cpu")
    faulted = None
    td, jd = [], []
    for lo in range(0, PLAN_TICKS + HEAL_TICKS, WIN):
        hi = lo + WIN
        in_plan = hi <= PLAN_TICKS
        js, jns, jfx = jeng.run_ticks(
            js, jns,
            _window_inputs(jm if in_plan else None, lo, hi, True, P),
            collect=True)
        ts, tns, tfx = teng.run_ticks(
            ts, tns,
            _window_inputs(tm if in_plan else None, lo, hi, False, P),
            collect=True)
        tsn = to_numpy(ts)
        assert _signature(tsn) == _signature(js), (proto, lo)
        td.append(_digest(ts, tns, tfx, True))
        jd.append(_digest(js, jns, jfx, False))
        if hi == PLAN_TICKS:
            faulted = tsn
            check_agreement(tsn, G, R, W)
            assert (tsn["commit_bar"].max(axis=1) > 0).all(), proto
    fin = to_numpy(ts)
    check_agreement(fin, G, R, W)
    spread = fin["commit_bar"].max(axis=1) - fin["commit_bar"].min(axis=1)
    assert (spread <= 4 * P).all(), fin["commit_bar"]
    assert (fin["commit_bar"].max(axis=1)
            > faulted["commit_bar"].max(axis=1)).all()
    return td, jd


# --------------------------------------------------------------- live soak
@pytest.mark.parametrize("protocol", ["MultiPaxos"])
def test_live_soak_one_seed(protocol, tmp_path):
    """One seeded plan over the live soak's classes on a port cluster at
    G=2 (``tests/test_nemesis.py::TestLiveNemesisSoak``'s shape; seed 3,
    whose plan holds a torn WAL append and a crash-armed snapshot): a
    checked put within 20 s of the final heal, more than 20 recorded
    ops, a linearizable history, and only the crashes the plan
    injected."""
    from summerset_tpu_torch.nemesis_soak import run_one

    r = run_one(protocol, 3, ticks=48, tick_len=0.2, groups=2,
                device="cpu", classes=LIVE_SOAK, keys=("nk0", "nk1"),
                budget_ticks=4000, out=str(tmp_path / "soak.json"))
    assert r["ok"], r.get("error")
    assert 0 <= r["recovery_s"] < 20.0
    assert r["num_ops"] > 20
    assert not r["action_errors"], r["action_errors"]
    assert len(r["crashes"]) >= 2, r["crashes"]
    assert all("injected" in c for c in r["crashes"]), r["crashes"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("protocol", ["MultiPaxos", "Raft", "RSPaxos"])
def test_live_soak_matrix(protocol, seed, tmp_path):
    """The soak matrix of ``python -m summerset_tpu_torch.nemesis_soak
    --matrix``, less its QuorumLeases row: every soak class, 120 ticks."""
    from summerset_tpu_torch.nemesis_soak import run_one

    r = run_one(protocol, seed, groups=2, device="cpu",
                out=str(tmp_path / "soak.json"))
    assert r["ok"], r.get("error")
