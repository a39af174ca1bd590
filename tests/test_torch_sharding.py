"""The port's device mesh (``summerset_tpu_torch/core/sharding.py``)
against the JAX package's.

- Engine digests: MultiPaxos ``G=64, R=4, W=16, P=4``, three windows of 8
  ticks with the pauses and the durable reset of JAX
  ``tests/test_mesh_engine.py`` over a jittered, lossy network, at the
  meshes ``4x1`` and ``2x2``: the port's mesh digests equal, byte for
  byte, the port's mesh-less run, the JAX package's mesh-less run and the
  JAX package's run at the same mesh (on the 8 virtual CPU devices
  ``tests/conftest.py`` grants).  The port's shards sit on repeated CPU
  handles.
- Per-tick equivalence in the pattern of JAX
  ``tests/test_sharding_equivalence.py``: ``4x2`` at ``G=64, R=4``, 24
  ticks of the seeded pause and cut schedule, every state leaf equal to
  the JAX package's sharded run tick by tick.
- Every protocol on a mesh that splits the replica axis (every kernel
  steps a row window of its shard's rows; none needs its rows gathered),
  equal to the port's mesh-less run tick by tick (state and effects),
  EPaxos in both its device and host exec modes; the collective
  tally at ``2x2`` equal to the pairwise run and to the JAX package.
- The serving step on a ``(2, 1)`` mesh equal to the unsharded step and
  to the JAX package's sharded ``_shared_step``; a live 3-replica port
  cluster with ``device_mesh="2x1"`` reading back every acked key.
- Geometry errors: ``check_mesh``'s axis-named errors, ``mesh_for`` with
  too few devices, repeated devices refused unless asked for, and the
  layouts' whole trailing dims.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summerset_tpu.core import Engine as JEngine
from summerset_tpu.core import NetConfig as JNet
from summerset_tpu.core import sharding as jshard
from summerset_tpu.core.netmodel import ControlInputs as JCtrl
from summerset_tpu.protocols import make_protocol as jmake
from summerset_tpu.protocols.multipaxos import ReplicaConfigMultiPaxos as JMP
from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import Engine as TEngine
from summerset_tpu_torch.core import NetConfig as TNet
from summerset_tpu_torch.core import sharding as sl
from summerset_tpu_torch.protocols import make_protocol as tmake
from summerset_tpu_torch.protocols.multipaxos import ReplicaConfigMultiPaxos as TMP
from test_torch_engine import port_reset_rule

G, R, W, P = 64, 4, 16, 4
TICKS = 8
WINDOWS = 3
NET = dict(delay_ticks=1, jitter_ticks=1, drop_rate=0.05, max_delay_ticks=3)
CPUS = ["cpu"] * 8


def _jax_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual CPU devices (conftest grants 8)")
    return jax.devices()[:n]


def _window_seq(w):
    """JAX ``test_mesh_engine._window_seq``: proposals every tick,
    replica 1 paused at tick 3, a durable reset of replica 1 at tick 5 of
    window 1 (numpy, fed to both packages)."""
    t = np.arange(TICKS, dtype=np.int32)
    alive = np.ones((TICKS, G, R), bool)
    alive[3, :, 1] = False
    reset = np.zeros((TICKS, G, R), bool)
    if w == 1:
        reset[5, :, 1] = True
    return {
        "n_proposals": np.full((TICKS, G), P, np.int32),
        "value_base": np.broadcast_to(
            ((w * TICKS + t) * P)[:, None], (TICKS, G)).astype(np.int32),
        "alive": alive,
        "reset": reset,
    }


def _digest(state, fx_commit, fx_exec, extra):
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(np.asarray(state[k]).tobytes())
    h.update(np.asarray(fx_commit).tobytes())
    h.update(np.asarray(fx_exec).tobytes())
    for k in sorted(extra):
        h.update(np.asarray(extra[k]).tobytes())
    return h.hexdigest()


def _port_digests(eng):
    state, ns = eng.init()
    out = []
    for w in range(WINDOWS):
        seq = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in _window_seq(w).items()}
        state, ns, fx = eng.run_ticks(state, ns, seq, collect=True)
        full = {k: v.numpy() for k, v in sl.gather_pytree(state).items()}
        out.append(_digest(full, fx.commit_bar.numpy(), fx.exec_bar.numpy(),
                           {k: v.numpy() for k, v in fx.extra.items()}))
    return out, full


def _jax_digests(mesh=None):
    kernel = jmake("multipaxos", G, R, W, JMP(max_proposals_per_tick=P))
    with port_reset_rule():
        eng = JEngine(kernel, netcfg=JNet(**NET), seed=7, mesh=mesh)
        state, ns = eng.init()
        out = []
        for w in range(WINDOWS):
            seq = {k: jnp.asarray(v) for k, v in _window_seq(w).items()}
            state, ns, fx = eng.run_ticks(state, ns, seq, collect=True)
            out.append(_digest(
                {k: np.asarray(v) for k, v in state.items()},
                fx.commit_bar, fx.exec_bar,
                {k: np.asarray(v) for k, v in fx.extra.items()}))
    return out


@pytest.fixture(scope="module")
def port_kernel():
    return tmake("multipaxos", G, R, W, TMP(max_proposals_per_tick=P),
                 device="cpu")


@pytest.fixture(scope="module")
def baselines(port_kernel):
    """The port's and the JAX package's mesh-less digests."""
    port, full = _port_digests(
        TEngine(port_kernel, netcfg=TNet(**NET), seed=7, device="cpu"))
    assert int(full["commit_bar"].max()) > 0, "nothing committed"
    return port, _jax_digests()


@pytest.mark.parametrize("spec", ["4x1", "2x2"])
def test_mesh_digests_equal_meshless_and_jax(port_kernel, baselines, spec):
    gs, rs = sl.parse_mesh(spec)
    port_base, jax_base = baselines
    assert port_base == jax_base, "the mesh-less runs differ"
    eng = TEngine(port_kernel, netcfg=TNet(**NET), seed=7, device="cpu",
                  mesh=sl.mesh_for(gs, rs, CPUS, repeat=True))
    got, _ = _port_digests(eng)
    assert got == port_base, f"mesh {spec}: digests differ from mesh-less"
    jmesh = jshard.make_mesh(gs, rs, devices=_jax_devices(gs * rs))
    assert got == _jax_digests(jmesh), f"mesh {spec}: differs from JAX's"
    # a split replica axis moves lanes between shards; one does not
    assert (eng.xfer["bytes"] > 0) == (rs > 1)


def test_init_places_fresh_shards_on_their_devices(port_kernel):
    mesh = sl.mesh_for(2, 2, CPUS, repeat=True)
    eng = TEngine(port_kernel, netcfg=TNet(**NET), seed=7, device="cpu",
                  mesh=mesh)
    state, ns = eng.init()
    assert len(state.shards) == 4 and len(ns.shards) == 4
    assert state.shards[1]["commit_bar"].shape == (G // 2, R // 2)
    assert ns.shards[3]["rng"].shape == (G // 2, R // 2, R)
    # fresh copies: a shard never shares memory with the boot template
    boot = eng._boot["win_val"]
    for s in state.shards:
        assert s["win_val"].data_ptr() != boot.data_ptr()
        assert s["win_val"].untyped_storage().data_ptr() != \
            boot.untyped_storage().data_ptr()
    # the gathered state is the boot state
    for k, v in eng._boot.items():
        assert torch.equal(state[k], v)


# ------------------------------------------------------- per-tick 4x2 --
def test_group_and_replica_sharded_equivalence_per_tick():
    """JAX ``test_group_and_replica_sharded_equivalence``: 4x2 at G=64,
    R=4, 24 ticks of seeded pauses and cuts; every port state leaf equals
    the JAX package's sharded run tick by tick."""
    ticks = 24
    rng = np.random.default_rng(42)
    schedule = []
    for _ in range(ticks):
        alive = np.ones((G, R), bool)
        for r in range(R):
            if rng.random() < 0.2:
                alive[:, r] = False
        if rng.random() < 0.3:
            cut = int(rng.integers(R))
            link = np.asarray(JCtrl.isolate_links(G, R, cut))
        else:
            link = np.ones((G, R, R), bool)
        schedule.append((alive, link))

    def inputs_at(t, mod):
        alive, link = schedule[t]
        conv = jnp.asarray if mod == "jax" else torch.from_numpy
        return {
            "n_proposals": conv(np.full((G,), P, np.int32)),
            "value_base": conv(np.full((G,), (1 + t) * P, np.int32)),
            "alive": conv(alive),
            "link_up": conv(np.array(link)),
        }

    jk = jmake("multipaxos", G, R, W, JMP(max_proposals_per_tick=P))
    jeng = JEngine(jk, netcfg=JNet(**NET), seed=7,
                   mesh=jshard.make_mesh(4, 2, devices=_jax_devices(8)))
    tk = tmake("multipaxos", G, R, W, TMP(max_proposals_per_tick=P),
               device="cpu")
    teng = TEngine(tk, netcfg=TNet(**NET), seed=7, device="cpu",
                   mesh=sl.mesh_for(4, 2, CPUS, repeat=True))
    js, jn = jeng.init()
    ts, tn = teng.init()
    for t in range(ticks):
        js, jn, _ = jeng.tick(js, jn, inputs_at(t, "jax"))
        ts, tn, _ = teng.tick(ts, tn, inputs_at(t, "torch"))
        got = to_numpy(ts.gather())
        for k in js:
            np.testing.assert_array_equal(
                got[k], np.asarray(js[k]),
                err_msg=f"tick {t}: state[{k!r}] differs from JAX's 4x2 run")
    assert int(np.asarray(js["commit_bar"]).max()) > 0


# ----------------------------------------------------- every protocol --
PROTOCOLS = {
    # name -> (R, mesh, config overrides)
    "RSPaxos": (4, "2x2", dict(fault_tolerance=1)),
    "Raft": (4, "2x2", {}),
    "CRaft": (4, "2x2", {}),
    "Crossword": (4, "2x2", {}),
    "QuorumLeases": (4, "2x2", {}),
    "Bodega": (4, "2x2", {}),
    "EPaxos": (4, "2x2", {}),
    "EPaxos-host": (4, "1x4", dict(exec_follows_commit=False)),
    "ChainRep": (4, "1x4", {}),
    "SimplePush": (4, "2x2", {}),
    "RepNothing": (2, "2x2", {}),
    "MultiPaxos-collective": (4, "2x2", dict(tally="collective")),
}


def _schedule(g, r, ticks, seed):
    """Seeded pauses, an isolated replica now and then and a durable
    reset of half the groups' replica 1 at tick 12."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        alive = np.ones((g, r), bool)
        if rng.random() < 0.3:
            alive[:, int(rng.integers(r))] = False
        link = np.ones((g, r, r), bool)
        if rng.random() < 0.2:
            c = int(rng.integers(r))
            link[:, c, :] = False
            link[:, :, c] = False
            link[:, c, c] = True
        reset = np.zeros((g, r), bool)
        if t == 12:
            reset[: g // 2, min(1, r - 1)] = True
        out.append({
            "n_proposals": torch.full((g,), 4, dtype=torch.int32),
            "value_base": torch.full((g,), t * 4, dtype=torch.int32),
            "exec_floor": torch.full((g, r), 1 << 30, dtype=torch.int32),
            "alive": torch.from_numpy(alive),
            "link_up": torch.from_numpy(link),
            "reset": torch.from_numpy(reset),
        })
    return out


def _port_kernel(name, g, r, w, over):
    proto = name.split("-")[0]
    cfg = tmake(proto, g, r, 64, device="cpu").config
    kw = dict(over)
    if hasattr(cfg, "max_proposals_per_tick"):
        kw["max_proposals_per_tick"] = min(4, w // 2)
    return tmake(proto, g, r, w, dataclasses.replace(cfg, **kw),
                 device="cpu")


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_every_protocol_on_a_replica_splitting_mesh(name):
    r, spec, over = PROTOCOLS[name]
    g, w, ticks = 16, 16, 30
    k = _port_kernel(name, g, r, w, over)
    net = (TNet() if hasattr(k.config, "lease_margin") else TNet(**NET))
    sched = _schedule(g, r, ticks, seed=1)
    if name == "EPaxos-host":
        # host mode: one proposing replica per group, explicit vids and
        # the executors' floors (held at 0: nothing applied)
        for t, inp in enumerate(sched):
            inp["prop_replica"] = torch.arange(g, dtype=torch.int32) % r
            inp["prop_vids"] = (torch.arange(4, dtype=torch.int32)[None]
                                + 8 * t + 1000 * torch.arange(
                                    g, dtype=torch.int32)[:, None])
            inp["exec_floor_rows"] = torch.zeros((g, r, r),
                                                 dtype=torch.int32)
    base = TEngine(k, netcfg=net, seed=3, device="cpu")
    gs, rs = sl.parse_mesh(spec)
    eng = TEngine(k, netcfg=net, seed=3, device="cpu",
                  mesh=sl.mesh_for(gs, rs, CPUS, repeat=True))
    s0, n0 = base.init()
    s1, n1 = eng.init()
    for t in range(ticks):
        s0, n0, f0 = base.tick(s0, n0, sched[t])
        s1, n1, f1 = eng.tick(s1, n1, sched[t])
        got = s1.gather()
        for key, v in s0.items():
            assert torch.equal(got[key], v), f"{name} tick {t}: {key}"
        assert torch.equal(f1.commit_bar, f0.commit_bar)
        for key, v in f0.extra.items():
            assert torch.equal(f1.extra[key], v), f"{name} tick {t}: fx {key}"
    assert int(s0["commit_bar"].max()) > 0, f"{name}: nothing committed"
    assert rs > 1 and eng.xfer["bytes"] > 0


def test_collective_tally_2x2_equals_pairwise_and_jax():
    """``tally="collective"`` at 2x2: the port's state digests equal its
    pairwise run and the JAX package's collective run (mesh-less; its
    own mesh gate holds that equal to its mesh)."""
    def port(tally, mesh):
        k = tmake("multipaxos", G, R, W,
                  TMP(max_proposals_per_tick=P, tally=tally), device="cpu")
        eng = TEngine(k, netcfg=TNet(**NET), seed=7, device="cpu",
                      mesh=mesh)
        state, ns = eng.init()
        out = []
        for w in range(WINDOWS):
            seq = {k2: torch.from_numpy(np.ascontiguousarray(v))
                   for k2, v in _window_seq(w).items()}
            state, ns, fx = eng.run_ticks(state, ns, seq, collect=True)
            full = sl.gather_pytree(state)
            out.append(_digest({k2: v.numpy() for k2, v in full.items()},
                               fx.commit_bar.numpy(), fx.exec_bar.numpy(),
                               {}))
        return out

    mesh = sl.mesh_for(2, 2, CPUS, repeat=True)
    coll = port("collective", mesh)
    assert coll == port("pairwise", None)
    kernel = jmake("multipaxos", G, R, W,
                   JMP(max_proposals_per_tick=P, tally="collective"))
    with port_reset_rule():
        eng = JEngine(kernel, netcfg=JNet(**NET), seed=7)
        state, ns = eng.init()
        jd = []
        for w in range(WINDOWS):
            seq = {k: jnp.asarray(v) for k, v in _window_seq(w).items()}
            state, ns, fx = eng.run_ticks(state, ns, seq, collect=True)
            jd.append(_digest({k: np.asarray(v) for k, v in state.items()},
                              fx.commit_bar, fx.exec_bar, {}))
    assert coll == jd


# ------------------------------------------------------ serving step --
def _loopback(kernel, out, swap):
    return {k: (v if k in kernel.broadcast_lanes else swap(v))
            for k, v in out.items()}


def test_shared_step_sharded_equivalence():
    """JAX ``test_shared_step_sharded_equivalence`` at (2, 1): the port's
    mesh step equals its unsharded step and the JAX package's sharded
    ``_shared_step`` on every state leaf, tick by tick."""
    from summerset_tpu.core import telemetry as jtel
    from summerset_tpu.host.server import _shared_step
    from summerset_tpu_torch.core import telemetry as ttel

    _jax_devices(2)
    g, r, w = 8, 3, 8
    jcfg = JMP(max_proposals_per_tick=1)
    jcfg.exec_follows_commit = False
    jk = jmake("multipaxos", g, r, w, jcfg)
    jstep = _shared_step(jk, (2, 1))
    tk = tmake("multipaxos", g, r, w,
               TMP(max_proposals_per_tick=1, exec_follows_commit=False),
               device="cpu")
    mstep = sl.mesh_step(tk, sl.mesh_for(2, 1, CPUS, repeat=True))

    js = jk.init_state(seed=0)
    jtel.attach(js, g, r)
    js = jshard.shard_pytree(jshard.mesh_for(2, 1), js)
    tu = tk.init_state(seed=0)
    ttel.attach(tu, g, r, "cpu")
    ts = sl.shard_pytree(sl.mesh_for(2, 1, CPUS, repeat=True), tu)
    jo, uo, so = jk.zero_outbox(), tk.zero_outbox(), tk.zero_outbox()
    tswap = lambda v: v.transpose(1, 2)  # noqa: E731
    for t in range(6):
        ti = {
            "n_proposals": torch.full((g,), 1, dtype=torch.int32),
            "value_base": torch.full((g,), 1 + t, dtype=torch.int32),
            "exec_floor": torch.full((g, r), 1 << 30, dtype=torch.int32),
        }
        ji = {k: jnp.asarray(v.numpy()) for k, v in ti.items()}
        js, jo, _ = jstep(js, _loopback(jk, jo, lambda v: jnp.swapaxes(
            v, 1, 2)), ji)
        tu, uo, _ = tk.step(tu, _loopback(tk, uo, tswap), ti)
        ts, so, _ = mstep(ts, _loopback(tk, so, tswap), ti)
        got = ts.gather()
        got_np = to_numpy(got)
        for k in tu:
            assert torch.equal(got[k], tu[k]), f"tick {t}: state[{k!r}]"
            np.testing.assert_array_equal(got_np[k], np.asarray(js[k]),
                                          err_msg=f"tick {t}: {k} vs JAX")
        for k in uo:
            assert torch.equal(so[k], uo[k]), f"tick {t}: outbox[{k!r}]"
    assert len(ts.shards) == 2
    assert int(tu["commit_bar"].max()) > 0


def test_live_cluster_with_device_mesh(tmp_path):
    """A 3-replica port cluster serving over a 2x1 mesh of repeated CPU
    handles: puts and gets round-trip, every replica's state sits on its
    two shards, no replica fault."""
    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import GenericEndpoint
    from summerset_tpu_torch.cluster import Cluster

    cluster = Cluster(
        "MultiPaxos", 3, str(tmp_path),
        config={"device_mesh": "2x1", "mesh_devices": "cpu,cpu"},
        num_groups=4, device="cpu",
    )
    try:
        ep = GenericEndpoint(cluster.manager_addr)
        ep.connect()
        drv = DriverClosedLoop(ep, timeout=5.0)
        for i in range(8):
            assert drv.put(f"mesh-k{i}", f"v{i}").kind == "success"
        for i in range(8):
            rep = drv.get(f"mesh-k{i}")
            assert rep.kind == "success"
            assert rep.result.value == f"v{i}"
        ep.leave()
        for rep in cluster.replicas.values():
            assert rep._mesh is not None
            assert isinstance(rep.state, sl.Sharded)
            assert [d == {"cpu"} for d in rep.state.devices()] == [True] * 2
        assert cluster.faults() == []
    finally:
        cluster.stop()


# ------------------------------------------------- geometry hardening --
def test_parse_mesh():
    assert sl.parse_mesh("4x2") == (4, 2)
    assert sl.parse_mesh("1X1") == (1, 1)
    for bad in ("4", "4x", "ax2", "0x1", "2x0"):
        with pytest.raises(ValueError):
            sl.parse_mesh(bad)


def test_make_mesh_device_count_mismatch():
    with pytest.raises(ValueError, match="!= 3 devices"):
        sl.make_mesh(2, 2, devices=["cpu"] * 3, repeat=True)


def test_mesh_for_too_few_devices(monkeypatch):
    with pytest.raises(ValueError, match="needs 8 devices but only 4"):
        sl.mesh_for(4, 2, devices=["cpu"] * 4, repeat=True)
    # the default list is the visible cards, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sl.visible_devices() == []
    with pytest.raises(ValueError, match="needs 2 devices but only 0"):
        sl.mesh_for(2, 1)


def test_repeated_devices_refused_unless_asked_for():
    with pytest.raises(ValueError, match="more than once"):
        sl.make_mesh(2, 1, devices=["cpu", "cpu"])
    mesh = sl.make_mesh(2, 1, devices=["cpu", "cpu"], repeat=True)
    assert mesh.shape == {"group": 2, "replica": 1}
    assert mesh.axis_names == ("group", "replica")


def test_check_mesh_axis_errors():
    mesh = sl.mesh_for(3, 1, CPUS, repeat=True)
    with pytest.raises(ValueError, match="group_shards=3"):
        sl.check_mesh(mesh, 64, 4)
    mesh = sl.mesh_for(1, 3, CPUS, repeat=True)
    with pytest.raises(ValueError, match="replica_shards=3"):
        sl.check_mesh(mesh, 64, 4)


def test_engine_and_server_refuse_indivisible_geometry(port_kernel,
                                                       tmp_path):
    from summerset_tpu_torch.host.server import ServerReplica

    with pytest.raises(ValueError, match="group_shards=3"):
        TEngine(port_kernel, device="cpu",
                mesh=sl.mesh_for(3, 1, CPUS, repeat=True))
    with pytest.raises(ValueError, match="replica_shards=3"):
        TEngine(port_kernel, device="cpu",
                mesh=sl.mesh_for(1, 3, CPUS, repeat=True))
    with pytest.raises(ValueError, match="replica_shards=2"):
        sl.mesh_step(tmake("multipaxos", 4, 3, 64, device="cpu"),
                     sl.mesh_for(1, 2, CPUS, repeat=True))
    # a server refuses before it joins anything: groups the mesh cannot
    # split, and a mesh of cards this host does not have (no CPU
    # fallback: repeated handles come only from ``mesh_devices``)
    addr = ("127.0.0.1", 1)
    with pytest.raises(ValueError, match="group_shards=2"):
        ServerReplica("MultiPaxos", addr, addr, addr, num_groups=3,
                      config={"device_mesh": "2x1",
                              "mesh_devices": "cpu,cpu"},
                      backer_dir=str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 devices but only 0"):
            ServerReplica("MultiPaxos", addr, addr, addr, num_groups=4,
                          config={"device_mesh": "2x1"},
                          backer_dir=str(tmp_path), device="cpu")


def test_layouts_keep_trailing_dims_whole(port_kernel):
    mesh = sl.mesh_for(2, 2, CPUS, repeat=True)
    st = port_kernel.init_state(0)
    specs = sl.state_sharding(mesh, st)
    assert specs["commit_bar"] == ("group", "replica")
    assert specs["win_val"] == ("group", "replica", None)
    eng = TEngine(port_kernel, netcfg=TNet(**NET), device="cpu")
    ns = eng.net.init_netstate(port_kernel.zero_outbox())
    nspec = sl.netstate_sharding(mesh, ns)
    assert nspec["rng"] == ("group", "replica", None)
    assert nspec["cursor"] == () and nspec["tick"] == ()
    for k, v in nspec["bufs"].items():
        assert v[:2] == (None, "group") or v[:3] == (None, None, "group")
    assert sl.mesh_stamp(4, 2, 64) == jshard.mesh_stamp(4, 2, 64)


def test_dryrun_multichip_on_repeated_cpu_handles():
    from summerset_tpu_torch.entry import dryrun_multichip

    got = dryrun_multichip(8, CPUS)
    assert got["mesh"] == "4x2" and got["committed"] > 0
    assert got["xfer_bytes"] > 0
