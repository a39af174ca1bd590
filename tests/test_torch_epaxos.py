"""The port's EPaxos kernel and host executor against the JAX package,
exactly, and the EPaxos properties of the JAX tests run on the port alone.

Digest cases follow ``tests/test_torch_basic.py``: both engines start from
the JAX boot state carried across through ``summerset_tpu_torch.convert``
and run windows of the same per-tick inputs.  After every window the
sha256 digest of every state leaf, the stacked effects (``exec_go``,
``exec_seq`` and ``exec_val`` included) and the netstate must be equal,
and so must the state signatures.  Tolerance: none, every compared value
is an integer or a bool.

The host-exec case steps both engines tick by tick in host mode
(``exec_follows_commit=False``): ``prop_replica`` rotates, ``prop_vids``
are minted per bucket in the residue classes of ``host/server.py``, and
each side's ``exec_floor_rows`` come from its own executors (the JAX
``EPaxosExecutor`` beside the JAX engine, the port's beside the port),
one per (group, replica); the executors' apply orders must be equal too.

The executor cases are the seven of ``tests/test_epaxos_exec.py`` run on
the port's ``EPaxosExecutor``, and a seeded equivalence over random 2-D
committed spaces (cycles, gaps, lost columns, payload refusals).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_epaxos_exec
from smr_helpers import _epaxos_common_floors, epaxos_check_and_merge
from summerset_tpu.core import Engine as JEngine
from summerset_tpu.core import NetConfig as JNet
from summerset_tpu.core.engine import reset_durable_rows as jreset
from summerset_tpu.host.epaxos_exec import EPaxosExecutor as JExec
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.epaxos import ReplicaConfigEPaxos as JEP
from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import Engine as TEngine
from summerset_tpu_torch.core import NetConfig as TNet
from summerset_tpu_torch.core.engine import reset_durable_rows
from summerset_tpu_torch.host.epaxos_exec import COMMITTED
from summerset_tpu_torch.host.epaxos_exec import EPaxosExecutor as TExec
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.epaxos import ReplicaConfigEPaxos as TEP
from test_epaxos import exec_orders
from test_torch_engine import _common_start, _digest_window, _signature

W = 32
BOOL_LANES = ("ow_noop", "ro_noop", "rv_noop", "rv_bump")


def _paused_then_reset(abs_t, T, alive, reset, n_prop):
    """Replica 1 paused at tick 3, durably reset at tick 5 of window 1."""
    alive[abs_t == 3, :, 1] = False
    reset[abs_t == T + 5, :, 1] = True


def _row_failover(abs_t, T, alive, reset, n_prop):
    """Replica 0 paused from tick 20 for 100 ticks."""
    alive[(abs_t >= 20) & (abs_t < 120), :, 0] = False


def _recoverer_dies(abs_t, T, alive, reset, n_prop):
    """Replica 0 dies at tick 20; its first recoverer (replica 1) dies
    mid-campaign at tick 34 (no proposals in between), as
    ``tests/test_epaxos.py::TestConcurrentRecoverers``."""
    alive[abs_t >= 20, :, 0] = False
    n_prop[(abs_t >= 20) & (abs_t < 34)] = 0
    alive[abs_t >= 34, :, 1] = False


def _fault_sweep(case):
    """The randomized fault schedule of ``tests/test_property_sweep.py``
    (seed 3, five segments): each segment pauses a random replica subset
    (majority loss included) and cuts a random replica off for 32 or 64
    ticks, then a 128-tick heal."""
    import random
    import zlib

    G, R, P = case["G"], case["R"], case["P"]
    rng = random.Random(1000 * 3 + zlib.crc32(b"epaxos"))
    seqs, base = [], 1
    for seg in range(6):
        alive = np.ones((G, R), bool)
        link = np.ones((G, R, R), bool)
        ticks = 128
        if seg < 5:
            for r in range(R):
                if rng.random() < 0.25:
                    alive[:, r] = False
            if rng.random() < 0.4:
                cut = rng.randrange(R)
                link[:, cut, :] = link[:, :, cut] = False
                link[:, cut, cut] = True
            ticks = rng.choice([32, 64])
        t = np.arange(ticks)
        seqs.append({
            "n_proposals": np.full((ticks, G), P, np.int32),
            "value_base": np.broadcast_to(
                ((base + t) * P)[:, None], (ticks, G)).astype(np.int32),
            "alive": np.broadcast_to(alive, (ticks, G, R)).copy(),
            "link_up": np.broadcast_to(link, (ticks, G, R, R)).copy(),
        })
        base += ticks
    return seqs


# name -> dict(G, R, P, cfg kwargs, net kwargs, T ticks per window,
# windows, schedule); a ``plan`` builds the windows itself
CASES = {
    "epaxos-default": dict(
        G=4, R=5, P=5, cfg=dict(num_key_buckets=8), net={}, T=20,
        windows=3, sched=_paused_then_reset),
    "epaxos-interference-k2": dict(
        G=4, R=5, P=5, cfg=dict(num_key_buckets=2), net={}, T=20,
        windows=3, sched=_paused_then_reset),
    "epaxos-drops-jitter": dict(
        G=2, R=5, P=5, cfg=dict(alive_timeout=25),
        net=dict(delay_ticks=1, jitter_ticks=2, drop_rate=0.15,
                 max_delay_ticks=4),
        T=30, windows=3, sched=_paused_then_reset),
    "epaxos-row-failover": dict(
        G=2, R=5, P=5, cfg=dict(alive_timeout=10), net={}, T=30,
        windows=4, sched=_row_failover),
    "epaxos-recoverer-dies": dict(
        G=1, R=5, P=5, cfg=dict(alive_timeout=10), net={}, T=30,
        windows=5, sched=_recoverer_dies),
    "epaxos-partition-sweep": dict(
        G=4, R=3, P=4, cfg=dict(num_key_buckets=2),
        net=dict(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
                 max_delay_ticks=3),
        plan=_fault_sweep),
    "epaxos-host-exec": dict(
        G=2, R=3, P=4, cfg=dict(num_key_buckets=4,
                                exec_follows_commit=False),
        net={}, T=20, windows=3, sched=None),
}


def _kernels(case):
    cfg = dict(max_proposals_per_tick=case["P"], **case["cfg"])
    G, R = case["G"], case["R"]
    return (jmake("epaxos", G, R, W, JEP(**cfg)),
            tmake("epaxos", G, R, W, TEP(**cfg), device="cpu"))


def _window_seq(case, w):
    G, R, P, T = case["G"], case["R"], case["P"], case["T"]
    abs_t = w * T + np.arange(T)
    alive = np.ones((T, G, R), bool)
    reset = np.zeros((T, G, R), bool)
    n_prop = np.full((T, G), P, np.int32)
    case["sched"](abs_t, T, alive, reset, n_prop)
    return {
        "n_proposals": n_prop,
        "value_base": np.broadcast_to(
            (abs_t * P + 1)[:, None], (T, G)).astype(np.int32),
        "alive": alive,
        "reset": reset,
    }


def _port_digest(ts, tns, fx):
    return _digest_window(to_numpy(ts), to_numpy(tns), fx)


def _np_fx(fx):
    return {"commit_bar": fx.commit_bar.numpy(),
            "exec_bar": fx.exec_bar.numpy(),
            "extra": {k: v.numpy() for k, v in fx.extra.items()}}


def _run_both(name):
    case = CASES[name]
    jk, tk = _kernels(case)
    jeng = JEngine(jk, netcfg=JNet(**case["net"]), seed=11)
    teng = TEngine(tk, netcfg=TNet(**case["net"]), seed=11, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    jd, td = [], []
    plan = case.get("plan")
    seqs = plan(case) if plan else [_window_seq(case, w)
                                    for w in range(case["windows"])]
    for w, seq in enumerate(seqs):
        js, jns, jfx = jeng.run_ticks(
            js, jns, {k: jnp.asarray(v) for k, v in seq.items()},
            collect=True)
        ts, tns, tfx = teng.run_ticks(ts, tns, seq, collect=True)
        jd.append(_digest_window(
            js, jns, {"commit_bar": jfx.commit_bar, "exec_bar": jfx.exec_bar,
                      "extra": jfx.extra}))
        assert _signature(to_numpy(ts)) == _signature(js), f"window {w}"
        td.append(_port_digest(ts, tns, _np_fx(tfx)))
    return jd, td, to_numpy(ts), tns


# ------------------------------------------------------- host-exec driver --
class HostSide:
    """One engine in host mode, as ``host/server.py`` drives it: the
    proposing replica rotates with the tick, mints one vid per proposed
    bucket in the residue class ``bucket + K * me (mod K * R)``, with the
    window space read from the previous tick's ``exec_row``; every
    (group, replica) runs its own executor, whose floors are that
    replica's row of the next tick's ``exec_floor_rows``."""

    def __init__(self, exec_cls, G, R, K, P):
        self.G, self.R, self.K, self.P = G, R, K, P
        self.next_vid = [1] * G
        self.applied = {(g, r): [] for g in range(G) for r in range(R)}
        self.execs = {
            (g, r): exec_cls(R, W, self._recorder(g, r))
            for g in range(G) for r in range(R)
        }

    def _recorder(self, g, r):
        def apply(row, col, vid, noop):
            self.applied[(g, r)].append((row, col, int(vid), bool(noop)))
        return apply

    def inputs(self, st, t, rng):
        G, R, K, P = self.G, self.R, self.K, self.P
        me = t % R
        pv = np.zeros((G, P), np.int32)
        n_prop = np.zeros(G, np.int32)
        for g in range(G):
            buckets = [int(b) for b in rng.permutation(K)[
                :int(rng.integers(0, K + 1))]]
            space = max(0, int(st["exec_row"][g, me, me]) + W
                        - int(st["own_next"][g, me]))
            take = buckets[:min(P, space)]
            for i, b in enumerate(take):
                vid = self.next_vid[g]
                vid += (b + K * me - vid) % (K * R)
                self.next_vid[g] = vid + 1
                pv[g, i] = vid
            n_prop[g] = len(take)
        floors = np.zeros((G, R, R), np.int32)
        for (g, r), ex in self.execs.items():
            floors[g, r] = ex.floor
        return {
            "n_proposals": n_prop,
            "value_base": pv[:, 0].copy(),
            "prop_replica": np.full(G, me, np.int32),
            "prop_vids": pv,
            "exec_floor_rows": floors,
        }

    def advance(self, st):
        for (g, r), ex in self.execs.items():
            ex.advance(st["abs2"][g, r], st["st2"][g, r], st["seq2"][g, r],
                       st["val2"][g, r], st["noop2"][g, r],
                       st["deps2"][g, r], st["cmt_row"][g, r])


def _run_host_both(name):
    import jax

    case = CASES[name]
    G, R, P, T = case["G"], case["R"], case["P"], case["T"]
    K = case["cfg"]["num_key_buckets"]
    jk, tk = _kernels(case)
    jeng = JEngine(jk, seed=11)
    teng = TEngine(tk, seed=11, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    jtick = jax.jit(jeng.tick)
    jside = HostSide(JExec, G, R, K, P)
    tside = HostSide(TExec, G, R, K, P)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    jd, td = [], []
    for w in range(case["windows"]):
        jfxs, tfxs = [], []
        for t in range(w * T, (w + 1) * T):
            jst = {k: np.asarray(v) for k, v in js.items()}
            jin = jside.inputs(jst, t, jrng)
            js, jns, jfx = jtick(js, jns, {k: jnp.asarray(v)
                                            for k, v in jin.items()})
            jside.advance({k: np.asarray(v) for k, v in js.items()})
            tin = tside.inputs(to_numpy(ts), t, trng)
            ts, tns, tfx = teng.tick(ts, tns, tin)
            tside.advance(to_numpy(ts))
            jfxs.append(jfx)
            tfxs.append(tfx)
        jd.append(_digest_window(js, jns, {
            "commit_bar": np.stack([f.commit_bar for f in jfxs]),
            "exec_bar": np.stack([f.exec_bar for f in jfxs]),
            "extra": {k: np.stack([f.extra[k] for f in jfxs])
                      for k in jfxs[0].extra}}))
        td.append(_port_digest(ts, tns, {
            "commit_bar": torch.stack([f.commit_bar for f in tfxs]).numpy(),
            "exec_bar": torch.stack([f.exec_bar for f in tfxs]).numpy(),
            "extra": {k: torch.stack([f.extra[k] for f in tfxs]).numpy()
                      for k in tfxs[0].extra}}))
    return jd, td, to_numpy(ts), jside, tside


def _check_bucket_prefixes(applied, G, R, K):
    """Every replica of a group applied the same order per bucket
    (``vid % K``), up to the shorter one's length (EPaxos's determinism
    guarantee).  ``applied[(g, r)]`` lists ``(row, col, vid, noop)``;
    returns the longest per-bucket run summed over groups and buckets."""
    total = 0
    for g in range(G):
        for b in range(K):
            seqs = [[a[:3] for a in applied[(g, r)] if a[2] % K == b]
                    for r in range(R)]
            for r in range(1, R):
                n = min(len(seqs[0]), len(seqs[r]))
                assert seqs[0][:n] == seqs[r][:n], (g, b, r)
            total += max(len(q) for q in seqs)
    return total


def _check_host_exec(final, jside, tside, case):
    G, R, K = case["G"], case["R"], case["cfg"]["num_key_buckets"]
    # the executors emitted the same apply orders on both sides
    assert tside.applied == jside.applied
    assert sum(map(len, tside.applied.values())) > 0, "nothing applied"
    # exec_row follows the floors: the kernel clips the host floor to
    # [exec_row, cmt_row], and the floor never passes cmt_row
    assert (final["exec_row"] <= final["cmt_row"]).all()
    for (g, r), ex in tside.execs.items():
        assert (final["exec_row"][g, r] <= np.asarray(ex.floor)).all()
    assert int(final["exec_row"].sum()) > 0
    _check_bucket_prefixes(tside.applied, G, R, K)


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_digests_equal_jax(name):
    case = CASES[name]
    if name == "epaxos-host-exec":
        jd, td, final, jside, tside = _run_host_both(name)
        assert td == jd
        _check_host_exec(final, jside, tside, case)
        return
    jd, td, final, tns = _run_both(name)
    assert td == jd
    G, R = case["G"], case["R"]
    assert int(final["cmt_row"].max()) > 0, "nothing committed"
    epaxos_check_and_merge(final, G, R, {})
    D = case["net"].get("max_delay_ticks", 1)
    if D > 1:
        for k in BOOL_LANES:
            buf = tns["bufs"][k]
            assert buf.dtype == torch.bool and buf.shape[0] == D, k
    if name == "epaxos-row-failover":
        # row 0's tail resolved at every survivor
        ext0 = final["ext_row"][:, 1:, 0].max(axis=1)
        assert (final["cmt_row"][:, 1:, 0] >= ext0[:, None]).all()
        assert (final["cmt_row"][:, 1:, 1:] > 60).all()
    if name == "epaxos-recoverer-dies":
        live = [2, 3, 4]
        for dead_row in (0, 1):
            ext = final["ext_row"][:, live, dead_row].max(axis=1)
            assert (final["cmt_row"][:, live, dead_row] >= ext[:, None]).all()
        assert int(final["rbm"][0, 2:, 0].max()) > (1 << 8)


def test_reset_and_restore_durable_match_jax():
    case = CASES["epaxos-default"]
    jk, tk = _kernels(case)
    jeng, teng = JEngine(jk, seed=3), TEngine(tk, seed=3, device="cpu")
    (js, jns), (ts, tns) = _common_start(jeng, teng)
    seq = _window_seq(case, 0)
    js, jns, _ = jeng.run_ticks(
        js, jns, {k: jnp.asarray(v) for k, v in seq.items()})
    ts, tns, _ = teng.run_ticks(ts, tns, seq)
    G, R = case["G"], case["R"]
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


# ------------------------------------------------- properties, port alone --
def _port_engine(G, R, P, net=None, seed=0, **cfg):
    k = tmake("epaxos", G, R, W, TEP(max_proposals_per_tick=P, **cfg),
              device="cpu")
    return TEngine(k, netcfg=TNet(**(net or {})), seed=seed, device="cpu")


def _check_port_exec_prefix(st, G, R, K):
    """``smr_helpers.epaxos_check_exec_prefix`` with the port's executor:
    from common start floors, every replica's executor applies its own
    view; returns the instances executed."""
    applied = {}
    for g in range(G):
        floors = _epaxos_common_floors(st, g, R, W)
        for r in range(R):
            rec = applied[(g, r)] = []
            ex = TExec(R, W, lambda row, col, vid, noop, rec=rec: rec.append(
                (row, col, int(vid), bool(noop))))
            ex.floor = list(floors)
            ex.advance(st["abs2"][g, r], st["st2"][g, r], st["seq2"][g, r],
                       st["val2"][g, r], st["noop2"][g, r],
                       st["deps2"][g, r], st["cmt_row"][g, r])
    return _check_bucket_prefixes(applied, G, R, K)


@pytest.mark.parametrize("schedule", ["interference-drops", "row-failover"])
def test_port_agreement_and_execution_order(schedule):
    """Committed (value, seq, noop, deps) agreement across replicas and
    durability across segments (``smr_helpers.epaxos_check_and_merge``),
    host-Tarjan per-bucket prefix agreement with the port's executor, and
    the device heuristic's per-bucket order agreement, on the port alone.
    Under constant interference every dependency chain reaches the
    uncommitted tail, so the last segment drains (no proposals) and the
    host executor catches up."""
    G, R, P, K = 2, 5, 5, 2
    if schedule == "interference-drops":
        eng = _port_engine(G, R, P, seed=4, num_key_buckets=K,
                           alive_timeout=25,
                           net=dict(delay_ticks=1, jitter_ticks=2,
                                    drop_rate=0.1, max_delay_ticks=4))
    else:
        eng = _port_engine(G, R, P, num_key_buckets=K, alive_timeout=10)
    st, ns = eng.init()
    acc, fxs = {}, []
    executed = 0
    for seg in range(4):
        T = 30
        t = np.arange(seg * T, (seg + 1) * T)
        alive = np.ones((T, G, R), bool)
        if schedule == "row-failover":
            alive[t >= 30, :, 0] = False
        seq = {"n_proposals": np.full((T, G), P if seg < 3 else 0,
                                      np.int32),
               "value_base": np.broadcast_to((t * P + 1)[:, None],
                                             (T, G)).astype(np.int32),
               "alive": alive}
        st, ns, fx = eng.run_ticks(st, ns, seq, collect=True)
        fxs.append(fx)
        stn = to_numpy(st)
        epaxos_check_and_merge(stn, G, R, acc)
        executed = _check_port_exec_prefix(stn, G, R, K)
    assert len(acc) > 100 and executed > 10
    # the device heuristic's emitted orders agree per bucket too
    extra = {k: torch.cat([f.extra[k] for f in fxs]).numpy()
             for k in ("exec_go", "exec_seq", "exec_val")}
    live = range(1, R) if schedule == "row-failover" else range(R)
    orders = exec_orders(SimpleNamespace(extra=extra), G, R, K)
    for g in range(G):
        ref = orders[(g, live[0])]
        for r in live:
            for b in range(K):
                n = min(len(ref[b]), len(orders[(g, r)][b]))
                assert ref[b][:n] == orders[(g, r)][b][:n], (g, r, b)
                assert n > 10


def test_port_vid_list_proposes_all_buckets_one_tick():
    """``tests/test_epaxos.py::TestMultiBucketIntake`` case 1 on the port."""
    G, R, K = 1, 3, 4
    eng = _port_engine(G, R, 4, num_key_buckets=K)
    st, ns = eng.init()
    me = 0
    vids = [1 + K * me, 3 + K * me, 0 + K * me + K * R]
    pv = np.zeros((G, 4), np.int32)
    pv[0, :3] = vids
    st, ns, _ = eng.tick(st, ns, {
        "n_proposals": np.asarray([3], np.int32),
        "value_base": np.asarray([vids[0]], np.int32),
        "prop_replica": np.asarray([me], np.int32),
        "prop_vids": pv,
    })
    stn = to_numpy(st)
    assert int(stn["own_next"][0, me]) == 3
    got = [int(stn["val2"][0, me, me, p]) for p in range(3)]
    assert got == vids
    assert len({v % K for v in got}) == 3


def test_port_multi_bucket_commits_under_run():
    """``tests/test_epaxos.py::TestMultiBucketIntake`` case 2 on the port."""
    G, R, K = 2, 3, 4
    eng = _port_engine(G, R, 4, num_key_buckets=K)
    st, ns = eng.init()
    me = 0
    proposed = []
    next_res = [1, 1]
    for t in range(30):
        pv = np.zeros((G, 4), np.int32)
        n = 0
        if t < 10:
            for b in range(2):
                vid = b + K * me + K * R * next_res[b]
                next_res[b] += 1
                pv[:, n] = vid
                n += 1
                proposed.append(vid)
        st, ns, _ = eng.tick(st, ns, {
            "n_proposals": np.full((G,), n, np.int32),
            "value_base": np.full((G,), int(pv[0, 0]), np.int32),
            "prop_replica": np.full((G,), me, np.int32),
            "prop_vids": pv,
        })
    stn = to_numpy(st)
    epaxos_check_and_merge(stn, G, R, {})
    for g in range(G):
        vids = {int(stn["val2"][g, 0, row, p])
                for row in range(R) for p in range(W)
                if stn["st2"][g, 0, row, p] == COMMITTED
                and stn["abs2"][g, 0, row, p] >= 0}
        assert set(proposed) <= vids, sorted(set(proposed) - vids)


# ------------------------------------------------------------- executor --
EXEC_CASES = sorted(n for n in dir(test_epaxos_exec.TestExecutor)
                    if n.startswith("test_"))


@pytest.mark.parametrize("case", EXEC_CASES)
def test_port_executor_cases(case, monkeypatch):
    """The seven ``tests/test_epaxos_exec.py`` cases, the port's class in
    place of the JAX package's."""
    assert len(EXEC_CASES) == 7
    monkeypatch.setattr(test_epaxos_exec, "EPaxosExecutor", TExec)
    getattr(test_epaxos_exec.TestExecutor(), case)()


def _random_space(rng):
    """A random committed 2-D window: mostly committed columns from each
    row's floor, with uncommitted gaps, lost columns (the window holds
    another column or none), random dependency bars (cycles, bars past
    the committed frontier) and no-ops."""
    R = int(rng.integers(2, 6))
    Wr = int(rng.choice([4, 8, 16]))
    floor = rng.integers(0, 6, size=R)
    cmt = floor + rng.integers(0, Wr + 1, size=R)
    abs2 = np.full((R, Wr), -1, np.int32)
    st2 = np.zeros((R, Wr), np.int32)
    seq2 = rng.integers(1, 12, size=(R, Wr)).astype(np.int32)
    val2 = rng.integers(1, 60, size=(R, Wr)).astype(np.int32)
    noop2 = rng.random((R, Wr)) < 0.1
    deps2 = np.zeros((R, Wr, R), np.int32)
    for r in range(R):
        for c in range(int(floor[r]), int(floor[r]) + Wr):
            p = c % Wr
            u = rng.random()
            abs2[r, p] = c if u > 0.04 else (c - Wr if u > 0.02 else -1)
            st2[r, p] = COMMITTED if (c < cmt[r] and rng.random() > 0.05) \
                else int(rng.integers(0, 3))
            for r2 in range(R):
                if r2 != r and rng.random() < 0.5:
                    deps2[r, p, r2] = int(rng.integers(0, cmt[r2] + 3))
    # payloads not here yet for about one value in six
    refused = {int(v) for v in val2.flat if rng.random() < 0.15}
    return (R, Wr, floor, (abs2, st2, seq2, val2, noop2, deps2, cmt),
            refused)


@pytest.mark.parametrize("chunk", range(8))
def test_port_executor_equals_jax_on_random_spaces(chunk):
    """64 seeds: the same apply sequence, floors and ``lost_rows`` from
    the JAX and port executors over two advances (payloads refused, then
    all present)."""
    for seed in range(chunk * 8, chunk * 8 + 8):
        R, Wr, floor, space, refused = _random_space(
            np.random.default_rng(seed))
        got = {}
        for cls in (JExec, TExec):
            seqs = []
            ex = cls(R, Wr, lambda r, c, v, n: seqs.append((r, c, v, n)))
            ex.floor = [int(f) for f in floor]
            f1 = ex.advance(*space, payload_ok=lambda v, n: n
                            or v not in refused)
            lost1 = list(ex.lost_rows)
            f2 = ex.advance(*space)
            got[cls] = (seqs, f1, lost1, f2, list(ex.lost_rows))
        assert got[TExec] == got[JExec], seed
