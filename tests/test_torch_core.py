"""The port's core planes against the JAX package, exactly: quorum tallies,
telemetry folds, the shared protocol helpers and the network model's
delay lines (``summerset_tpu_torch/core``, ``protocols/common.py``).

Inputs are numpy draws from fixed seeds handed to both sides; uint32
lanes are compared through their int32 reinterpretation.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summerset_tpu.core import netmodel as jnet
from summerset_tpu.core import quorum as jq
from summerset_tpu.core import telemetry as jtel
from summerset_tpu.protocols import common as jcom
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.multipaxos import ReplicaConfigMultiPaxos as JCfg
from summerset_tpu.protocols.rspaxos import ReplicaConfigRSPaxos as JRCfg
from summerset_tpu_torch.convert import to_numpy, to_torch
from summerset_tpu_torch.core import netmodel as tnet
from summerset_tpu_torch.core import quorum as tq
from summerset_tpu_torch.core import telemetry as ttel
from summerset_tpu_torch.protocols import common as tcom
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.multipaxos import ReplicaConfigMultiPaxos as TCfg
from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos as TRCfg

G, R, W = 6, 5, 16


def _ints(seed, shape, lo=0, hi=8):
    return np.random.default_rng(seed).integers(
        lo, hi, size=shape).astype(np.int32)


def _eq(t, j):
    a, b = np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t), \
        np.asarray(j)
    if a.dtype == np.int32 and b.dtype == np.uint32:
        a = a.view(np.uint32)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- quorum --
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_quorum_frontier_with_ties(k):
    f = _ints(k, (G, R, R), 0, 4)  # few values: many ties
    _eq(tq.quorum_frontier(torch.from_numpy(f), k),
        jq.quorum_frontier(jnp.asarray(f), k))


def test_coverage_frontier():
    cover = _ints(1, (G, R, R), 0, 20)
    abs_w = _ints(2, (G, R, W), 0, 24)
    need = _ints(3, (G, R, W), 1, 4)
    known = _ints(4, (G, R, W), 0, 2).astype(bool)
    in_rng = _ints(5, (G, R, W), 0, 2).astype(bool)
    t = [torch.from_numpy(a) for a in (cover, abs_w, need, known, in_rng)]
    j = [jnp.asarray(a) for a in (cover, abs_w, need, known, in_rng)]
    _eq(tq.coverage_frontier(*t), jq.coverage_frontier(*j))


@pytest.mark.parametrize("collective", [False, True])
def test_pair_views_and_source_lane(collective):
    shape = (G, R) if collective else (G, R, R)
    inbox = {"a": _ints(6, shape), "b": _ints(7, shape)}
    tv = tq.pair_views({k: torch.from_numpy(v) for k, v in inbox.items()},
                       ("a", "b"), collective)
    jv = jq.pair_views({k: jnp.asarray(v) for k, v in inbox.items()},
                       ("a", "b"), collective)
    for k in ("a", "b"):
        _eq(tv[k], jv[k])
    gate = _ints(8, (G, R), 0, 2).astype(bool)
    val = _ints(9, (G, R), -5, 50)
    _eq(tq.source_lane(torch.from_numpy(gate), torch.from_numpy(val)),
        jq.source_lane(jnp.asarray(gate), jnp.asarray(val)))
    with pytest.raises(ValueError):
        tq.check_tally("gossip")


# ------------------------------------------------------------ telemetry --
def test_telemetry_accumulate_and_bump():
    block = _ints(10, (G, R, ttel.K), 0, 100)
    assert ttel.LANES == jtel.LANES
    contribs = [
        {"commits": _ints(11, (G, R)), "win_occupancy_hw": _ints(12, (G, R), 0, 200)},
        {"elections": _ints(13, (G, R), 0, 2).astype(bool)},
        {"win_occupancy_hw": _ints(14, (G, R), 0, 300)},
    ]
    tb, jb = torch.from_numpy(block), jnp.asarray(block)
    for cb in contribs:
        tb = ttel.accumulate(tb, {k: torch.from_numpy(v) for k, v in cb.items()})
        jb = jtel.accumulate(jb, {k: jnp.asarray(v) for k, v in cb.items()})
        _eq(tb, jb)
    for name in ("net_drops", "win_occupancy_hw", "commits"):
        v = _ints(len(name), (G, R), 0, 500)
        tb = ttel.bump(tb, name, torch.from_numpy(v))
        jb = jtel.bump(jb, name, jnp.asarray(v))
        _eq(tb, jb)
    with pytest.raises(KeyError):
        ttel.accumulate(tb, {"nope": torch.zeros((G, R), dtype=torch.int32)})


# ---------------------------------------------------------- common.py --
def test_range_cover_and_ballots():
    lo = _ints(20, (G, R), -3, 40)
    hi = lo + _ints(21, (G, R), 0, W + 1)
    tm, ta = tcom.range_cover(torch.from_numpy(lo), torch.from_numpy(hi), W)
    jm, ja = jcom.range_cover(jnp.asarray(lo), jnp.asarray(hi), W)
    _eq(tm, jm)
    _eq(ta, ja)
    bal = _ints(22, (G, R), 0, 5000)
    rid = np.broadcast_to(np.arange(R, dtype=np.int32), (G, R)).copy()
    _eq(tcom.make_greater_ballot(torch.from_numpy(bal), torch.from_numpy(rid)),
        jcom.make_greater_ballot(jnp.asarray(bal), jnp.asarray(rid)))
    assert tcom.initial_ballot(3) == int(jcom.initial_ballot(3))


@pytest.mark.parametrize("seed", range(4))
def test_best_by_ballot_equal_ballots_and_gathers(seed):
    flags = _ints(30 + seed, (G, R, R), 0, 64)
    bal = _ints(40 + seed, (G, R, R), 0, 3)  # ties everywhere
    tf, tb = torch.from_numpy(flags), torch.from_numpy(bal)
    jf, jb = jnp.asarray(flags.view(np.uint32)), jnp.asarray(bal)
    for bit in (1, 4, 16, 32):
        t = tcom.best_by_ballot(tf, bit, tb)
        j = jcom.best_by_ballot(jf, bit, jb)
        for a, b in zip(t, j):
            _eq(a, b)
        _eq(tcom.take_src(tb, t[2]), jcom.take_src(jb, j[2]))
        lane = _ints(50 + bit, (G, R, W), -1, 99)
        _eq(tcom.take_lane(torch.from_numpy(lane), t[2]),
            jcom.take_lane(jnp.asarray(lane), j[2]))
        _eq(tcom.dst_onehot(t[2], R), jcom.dst_onehot(j[2], R))
    _eq(tcom.not_self(G, R, "cpu"), jcom.not_self(G, R))


def test_client_intake_and_bars():
    s = {
        "exec_bar": _ints(60, (G, R), 0, 40),
        "next_slot": _ints(61, (G, R), 30, 60),
        "commit_bar": _ints(62, (G, R), 0, 50),
        "dur_bar": _ints(63, (G, R), 0, 50),
    }
    inputs = {"n_proposals": _ints(64, (G,), -3, 12),
              "value_base": _ints(65, (G,), 0, 1000),
              "exec_floor": _ints(66, (G, R), 0, 60)}
    serving = _ints(67, (G, R), 0, 2).astype(bool)
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    js = {k: jnp.asarray(v) for k, v in s.items()}
    ti = {k: torch.from_numpy(v) for k, v in inputs.items()}
    ji = {k: jnp.asarray(v) for k, v in inputs.items()}
    for a, b in zip(
        tcom.client_intake(ts, ti, torch.from_numpy(serving), 8, W),
        jcom.client_intake(js, ji, jnp.asarray(serving), 8, W),
    ):
        _eq(a, b)
    for lag in (0, 3):
        _eq(tcom.advance_durability(ts, lag), jcom.advance_durability(js, lag))
    for follows in (True, False):
        _eq(tcom.advance_exec(ts, ti, follows),
            jcom.advance_exec(js, ji, follows))


# ------------------------------------------------------------- netmodel --
def _digest(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            h.update(k.encode() + _digest(v).encode())
        else:
            a = np.asarray(v)
            h.update(k.encode() + str(a.dtype).encode() + str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _kernels(proto, tally):
    if proto == "multipaxos":
        jk = jmake(proto, G, R, W, JCfg(max_proposals_per_tick=4, tally=tally))
        tk = tmake(proto, G, R, W, TCfg(max_proposals_per_tick=4, tally=tally),
                   device="cpu")
    else:
        jk = jmake(proto, G, R, W, JRCfg(max_proposals_per_tick=4, tally=tally))
        tk = tmake(proto, G, R, W, TRCfg(max_proposals_per_tick=4, tally=tally),
                   device="cpu")
    return jk, tk


def _outbox(zero, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(zero):
        shape = np.asarray(zero[k]).shape
        if k == "flags":
            out[k] = rng.integers(0, 1024, size=shape).astype(np.uint32)
            out[k][rng.random(shape) < 0.3] = 0
        else:
            out[k] = rng.integers(-5, 500, size=shape).astype(np.int32)
    return out


NETS = {
    "d1_packed": dict(),
    "d1_loose": dict(pack_lanes=False),
    "d1_drops": dict(drop_rate=0.2),
    "jitter": dict(delay_ticks=1, jitter_ticks=2, drop_rate=0.1,
                   max_delay_ticks=4),
    "delay2": dict(delay_ticks=2, max_delay_ticks=3),
}


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("proto,tally", [("multipaxos", "pairwise"),
                                         ("rspaxos", "collective")])
def test_netmodel_pop_push_digests(net, proto, tally):
    jk, tk = _kernels(proto, tally)
    jcfg, tcfg = jnet.NetConfig(**NETS[net]), tnet.NetConfig(**NETS[net])
    assert jcfg.lanes_packed == tcfg.lanes_packed
    assert jcfg.max_delay_ticks == tcfg.max_delay_ticks
    jm = jnet.NetModel(jcfg, G, R, jk.broadcast_lanes, jk.tally_lanes)
    tm = tnet.NetModel(tcfg, G, R, tk.broadcast_lanes, tk.tally_lanes)
    jns = jm.init_netstate(jk.zero_outbox(), seed=3)
    tns = tm.init_netstate(tk.zero_outbox(), seed=3)
    assert _digest(to_numpy(tns)) == _digest(jns)
    rng = np.random.default_rng(7)
    jtel_b = jnp.zeros((G, R, jtel.K), jnp.int32)
    ttel_b = torch.zeros((G, R, ttel.K), dtype=torch.int32)
    for t in range(7):
        alive = rng.random((G, R)) > 0.15
        link = rng.random((G, R, R)) > 0.1
        ctrl_np = (alive if t % 3 else None, link if t % 2 else None)
        jc = jnet.ControlInputs(*(None if a is None else jnp.asarray(a)
                                  for a in ctrl_np))
        tc = tnet.ControlInputs(*(None if a is None else torch.from_numpy(a)
                                  for a in ctrl_np))
        jns, jin = jm.pop(jns, jc)
        tns, tin = tm.pop(tns, tc)
        assert _digest(to_numpy(tin)) == _digest(jin), f"inbox, tick {t}"
        ob = _outbox(jk.zero_outbox(), 100 + t)
        jns, jtel_b = jm.push(jns, {k: jnp.asarray(v) for k, v in ob.items()},
                              jc, telem=jtel_b)
        tns, ttel_b = tm.push(tns, to_torch(ob, "cpu"), tc, telem=ttel_b)
        assert _digest(to_numpy(tns)) == _digest(jns), f"netstate, tick {t}"
        _eq(ttel_b, jtel_b)
    assert int(ttel_b[..., ttel.LANE_IDX["net_drops"]].sum()) > 0


def test_control_input_factories():
    for t, j in [
        (tnet.ControlInputs.split_links(G, R, [0, 1]),
         jnet.ControlInputs.split_links(G, R, [0, 1])),
        (tnet.ControlInputs.isolate_links(G, R, 2, 4),
         jnet.ControlInputs.isolate_links(G, R, 2, 4)),
        (tnet.ControlInputs.one_way_down(G, R, 1, 3),
         jnet.ControlInputs.one_way_down(G, R, 1, 3)),
        (tnet.ControlInputs.skew_alive(G, R, 9, {1: 0.5, 3: 0.25}, offset=2),
         jnet.ControlInputs.skew_alive(G, R, 9, {1: 0.5, 3: 0.25}, offset=2)),
        (tnet.ControlInputs.links_all_up(G, R),
         jnet.ControlInputs.links_all_up(G, R)),
    ]:
        _eq(t, j)
    with pytest.raises(ValueError):
        tnet.NetConfig(pack_lanes=True, jitter_ticks=1)
