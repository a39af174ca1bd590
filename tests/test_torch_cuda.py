"""The port on the card: the GF(2^8) CUDA kernel against its plain PyTorch
version, and the card's engine (every protocol, EPaxos in both execution
modes) and codec against the port on the CPU.

Every test here needs an NVIDIA card and ``nvcc`` and skips elsewhere.
The file imports neither ``jax`` nor the JAX package, so it also runs on a
GPU machine without them, skipping ``tests/conftest.py`` (which imports
jax):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

Tolerance: exact.  Every compared value is an integer, and the kernel
repeats the plain version's wrapping int32 arithmetic.
"""

import functools
import hashlib
import itertools

import numpy as np
import pytest
import torch

from summerset_tpu_torch.convert import to_numpy
from summerset_tpu_torch.core import Engine, NetConfig
from summerset_tpu_torch.host.codeword import CodewordStore
from summerset_tpu_torch.ops import rscoding as trs
from summerset_tpu_torch.protocols import make_protocol
from summerset_tpu_torch.protocols.bodega import ReplicaConfigBodega
from summerset_tpu_torch.protocols.chain_rep import ReplicaConfigChainRep
from summerset_tpu_torch.protocols.craft import ReplicaConfigCRaft
from summerset_tpu_torch.protocols.crossword import ReplicaConfigCrossword
from summerset_tpu_torch.protocols.epaxos import ReplicaConfigEPaxos
from summerset_tpu_torch.host.epaxos_exec import EPaxosExecutor
from summerset_tpu_torch.protocols.multipaxos import ReplicaConfigMultiPaxos
from summerset_tpu_torch.protocols.quorum_leases import (
    ReplicaConfigQuorumLeases,
)
from summerset_tpu_torch.protocols.raft import ReplicaConfigRaft
from summerset_tpu_torch.protocols.rep_nothing import ReplicaConfigRepNothing
from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos
from summerset_tpu_torch.protocols.simple_push import ReplicaConfigSimplePush

SUBSETS = list(itertools.combinations(range(5), 3))


#: the shards replicas 1, 3 and 4 hold under Crossword's RS(6,4) at two
#: shards per replica (T=10, dj=2)
RS64_HELD = (2, 3, 6, 7, 8, 9)


def _tables():
    """The parity tables of RS(3,2), RS(2,1), RS(5,3) and RS(6,4), the ten
    3-of-5 decode tables of RS(3,2) and one 6-of-10 decode table of
    RS(6,4)."""
    out = {}
    for d, p in ((3, 2), (2, 1), (5, 3), (6, 4)):
        out[f"enc{d}{p}"] = trs._bitslice_coeffs(
            trs.build_encode_matrix(d, p)[d:])
    M = trs.build_encode_matrix(3, 2)
    for s in SUBSETS:
        out[f"dec{s}"] = trs._bitslice_coeffs(
            trs.gf_inv_matrix_host(M[list(s)]))
    out[f"dec64{RS64_HELD}"] = trs._bitslice_coeffs(
        trs.gf_inv_matrix_host(trs.build_encode_matrix(6, 4)[list(RS64_HELD)]))
    return out


TABLES = _tables()


def _lanes(seed, shape):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, size=shape, dtype=np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TABLES))
def test_kernel_matches_plain_on_card(name, cuda_device):
    tbl = torch.from_numpy(TABLES[name]).to(cuda_device)
    cols = tbl.shape[1]
    for shape in ((1024, cols, 384), (3, cols, 1000), (1, cols, 349568),
                  (2, 4, cols, 7)):
        x = torch.from_numpy(_lanes(7, shape)).to(cuda_device)
        before = trs.bitslice_gf256.launches
        got = trs.bitslice_gf256(tbl, x)
        torch.cuda.synchronize()
        assert trs.bitslice_gf256.launches == before + 1
        assert got.shape == shape[:-2] + (tbl.shape[0], shape[-1])
        assert torch.equal(got, trs._bitslice_matmul_plain(tbl, x))


@pytest.mark.cuda
def test_kernel_wrapper_on_card(cuda_device):
    tbl = torch.from_numpy(TABLES["enc32"])
    x = torch.from_numpy(_lanes(3, (2, 3, 16))).to(cuda_device)
    with pytest.raises(ValueError, match="tbl on"):
        trs._bitslice_cuda(tbl, x)
    before = trs.bitslice_gf256.launches
    empty = trs.bitslice_gf256(tbl.to(cuda_device), x[:0])
    assert tuple(empty.shape) == (0, 2, 16)
    assert trs.bitslice_gf256.launches == before  # nothing launched


def _digest(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            h.update(k.encode() + _digest(v).encode())
        else:
            a = np.asarray(v)
            h.update(f"{k}:{a.dtype}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _window(G, R, P, T, w):
    t = np.arange(T, dtype=np.int32)
    alive = np.ones((T, G, R), bool)
    alive[3, :, 1] = False
    alive[w * T + t >= 10, :, 0] = False  # the leader crashes at tick 10
    reset = np.zeros((T, G, R), bool)
    if w == 1:
        reset[5, :, 2] = True
    return {
        "n_proposals": np.full((T, G), P, np.int32),
        "value_base": np.broadcast_to(((w * T + t) * P)[:, None],
                                      (T, G)).astype(np.int32),
        "alive": alive,
        "reset": reset,
    }


CONFIGS = {
    "multipaxos": ReplicaConfigMultiPaxos,
    "rspaxos": functools.partial(ReplicaConfigRSPaxos, fault_tolerance=1),
    "raft": ReplicaConfigRaft,
    "craft": functools.partial(ReplicaConfigCRaft, fault_tolerance=1),
    "crossword": functools.partial(ReplicaConfigCrossword,
                                   fault_tolerance=1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("proto", sorted(CONFIGS))
def test_engine_on_card_matches_cpu(proto, cuda_device):
    G, R, W, P, T = 8, 5, 32, 4, 16
    fast = dict(max_proposals_per_tick=P, hear_timeout_lo=5,
                hear_timeout_hi=9, tally="collective")
    net = NetConfig(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
                    max_delay_ticks=3)
    digests = {}
    for dev in ("cpu", cuda_device):
        cfg = CONFIGS[proto](**fast)
        eng = Engine(make_protocol(proto, G, R, W, cfg, device=dev),
                     netcfg=net, seed=7, device=dev)
        st, ns = eng.init()
        out = []
        for w in range(3):
            st, ns, fx = eng.run_ticks(st, ns, _window(G, R, P, T, w),
                                       collect=True)
            out.append(_digest({"state": to_numpy(st), "net": to_numpy(ns),
                                "commit": fx.commit_bar.cpu().numpy(),
                                "extra": to_numpy(fx.extra)}))
        assert int(st["commit_bar"].max()) > 0
        digests[str(dev)] = out
    assert digests["cpu"] == digests[str(cuda_device)]


SLICE3 = {
    "quorumleases": ReplicaConfigQuorumLeases,
    "bodega": functools.partial(ReplicaConfigBodega, conf_timeout=12),
    "chainrep": ReplicaConfigChainRep,
    "simplepush": functools.partial(ReplicaConfigSimplePush, rep_degree=2),
    "repnothing": ReplicaConfigRepNothing,
}


def _slice3_window(G, R, P, T, w):
    """Proposals every tick, a conf change in window 0 (QuorumLeases'
    target {1, 2}; Bodega's roster announced by replica 0 at tick 0),
    replica 2 paused for ticks 20..27, replica 1 reset in window 1."""
    seq = _window(G, R, P, T, w)
    abs_t = w * T + np.arange(T)
    alive = np.ones((T, G, R), bool)
    alive[(abs_t >= 20) & (abs_t < 28), :, 2] = False
    seq["alive"] = alive
    seq["reset"] = np.zeros((T, G, R), bool)
    if w == 1:
        seq["reset"][5, :, 1] = True
    seq["conf_target"] = np.full((T, G), 0b00110, np.int32)
    seq["conf_init"] = np.where(abs_t == 0, 0, -1)[:, None].repeat(
        G, axis=1).astype(np.int32)
    seq["conf_leader_target"] = np.zeros((T, G), np.int32)
    seq["conf_resp_target"] = np.full((T, G), 0b00110, np.int32)
    seq["conf_bucket"] = np.full((T, G), -1, np.int32)
    return seq


@pytest.mark.cuda
@pytest.mark.parametrize("proto", sorted(SLICE3))
def test_slice3_kernels_on_card_match_cpu(proto, cuda_device):
    """QuorumLeases, Bodega, ChainRep, SimplePush and RepNothing on the
    card against the port on the CPU at G=8 on the jittered, lossy D=3
    line, with a pause, a reset and a conf change."""
    G, R, W, P, T = 8, 5, 32, 4, 16
    net = NetConfig(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
                    max_delay_ticks=3)
    digests = {}
    for dev in ("cpu", cuda_device):
        cfg = SLICE3[proto](max_proposals_per_tick=P)
        eng = Engine(make_protocol(proto, G, R, W, cfg, device=dev),
                     netcfg=net, seed=7, device=dev)
        st, ns = eng.init()
        out = []
        for w in range(3):
            st, ns, fx = eng.run_ticks(st, ns, _slice3_window(G, R, P, T, w),
                                       collect=True)
            out.append(_digest({"state": to_numpy(st), "net": to_numpy(ns),
                                "commit": fx.commit_bar.cpu().numpy(),
                                "extra": to_numpy(fx.extra)}))
        assert int(st["commit_bar"].max()) > 0
        digests[str(dev)] = out
    assert digests["cpu"] == digests[str(cuda_device)]


def _epaxos_window(G, R, P, T, w):
    """Proposals every tick, replica 1 paused at tick 3, replica 0 paused
    from tick 20 past alive_timeout (its row recovered by a successor),
    replica 2 durably reset in window 1."""
    seq = _window(G, R, P, T, w)
    abs_t = w * T + np.arange(T)
    alive = np.ones((T, G, R), bool)
    alive[abs_t == 3, :, 1] = False
    alive[abs_t >= 20, :, 0] = False
    seq["alive"] = alive
    return seq


@pytest.mark.cuda
def test_epaxos_on_card_matches_cpu(cuda_device):
    """EPaxos on the card against the port on the CPU at G=8 on the
    jittered, lossy D=3 line, with pauses, a row failover and a reset:
    the device-only execution path, whose row closure the CPU cannot
    show failing (integer matmul exists there, not on CUDA)."""
    G, R, W, P, T = 8, 5, 32, 5, 24
    net = NetConfig(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
                    max_delay_ticks=3)
    digests = {}
    for dev in ("cpu", cuda_device):
        cfg = ReplicaConfigEPaxos(max_proposals_per_tick=P, alive_timeout=10,
                                  num_key_buckets=4)
        eng = Engine(make_protocol("epaxos", G, R, W, cfg, device=dev),
                     netcfg=net, seed=7, device=dev)
        st, ns = eng.init()
        out = []
        for w in range(4):
            st, ns, fx = eng.run_ticks(st, ns, _epaxos_window(G, R, P, T, w),
                                       collect=True)
            out.append(_digest({"state": to_numpy(st), "net": to_numpy(ns),
                                "commit": fx.commit_bar.cpu().numpy(),
                                "extra": to_numpy(fx.extra)}))
        assert int(st["exec_row"].min()) > 0
        # row 0's tail is resolved at a survivor of every group (on a
        # lossy line a survivor that missed the recovery lanes may not
        # have learned it, as in the JAX kernel)
        ext0 = st["ext_row"][:, 1:, 0].amax(dim=1, keepdim=True)
        assert bool((st["cmt_row"][:, 1:, 0] >= ext0).any(dim=1).all())
        digests[str(dev)] = out
    assert digests["cpu"] == digests[str(cuda_device)]


@pytest.mark.cuda
def test_epaxos_host_exec_on_card_matches_cpu(cuda_device):
    """EPaxos in host mode (``exec_follows_commit=False``) on the card
    against the CPU at G=8: ``prop_replica`` rotates, one vid per bucket
    is minted in the residue class ``bucket + K * me (mod K * R)``, and
    each (group, replica) has its own ``EPaxosExecutor`` feeding its row
    of ``exec_floor_rows``; states and apply orders must be equal."""
    G, R, W, P, K, T = 8, 5, 32, 8, 8, 40
    runs = {}
    for dev in ("cpu", cuda_device):
        cfg = ReplicaConfigEPaxos(max_proposals_per_tick=P,
                                  num_key_buckets=K,
                                  exec_follows_commit=False)
        eng = Engine(make_protocol("epaxos", G, R, W, cfg, device=dev),
                     seed=7, device=dev)
        st, ns = eng.init()
        applied = {(g, r): [] for g in range(G) for r in range(R)}
        execs = {(g, r): EPaxosExecutor(
            R, W, lambda row, col, vid, noop, a=applied[(g, r)]: a.append(
                (row, col, vid, noop)))
            for g in range(G) for r in range(R)}
        rng = np.random.default_rng(3)
        nxt = [1] * G
        for t in range(T):
            sn = to_numpy(st)
            me = t % R
            pv = np.zeros((G, P), np.int32)
            n = np.zeros(G, np.int32)
            for g in range(G):
                space = max(0, int(sn["exec_row"][g, me, me]) + W
                            - int(sn["own_next"][g, me]))
                take = rng.permutation(K)[:int(rng.integers(0, K + 1))]
                for i, b in enumerate(take[:min(P, space)]):
                    vid = nxt[g] + (int(b) + K * me - nxt[g]) % (K * R)
                    nxt[g] = vid + 1
                    pv[g, i] = vid
                    n[g] = i + 1
            floors = np.zeros((G, R, R), np.int32)
            for (g, r), ex in execs.items():
                floors[g, r] = ex.floor
            st, ns, _ = eng.tick(st, ns, {
                "n_proposals": n, "value_base": pv[:, 0].copy(),
                "prop_replica": np.full(G, me, np.int32), "prop_vids": pv,
                "exec_floor_rows": floors})
            sn = to_numpy(st)
            for (g, r), ex in execs.items():
                ex.advance(sn["abs2"][g, r], sn["st2"][g, r],
                           sn["seq2"][g, r], sn["val2"][g, r],
                           sn["noop2"][g, r], sn["deps2"][g, r],
                           sn["cmt_row"][g, r])
        assert int(st["exec_row"].sum()) > 0
        runs[str(dev)] = (_digest({"state": to_numpy(st),
                                   "net": to_numpy(ns)}), applied)
    assert runs["cpu"] == runs[str(cuda_device)]


@pytest.mark.cuda
def test_codec_on_card_matches_cpu(cuda_device):
    card = trs.RSCode(3, 2, device=cuda_device)
    host = trs.RSCode(3, 2, device="cpu")
    for size in (1, 4096, 70001):
        buf = np.random.default_rng(size).integers(
            0, 256, size=size, dtype=np.uint8).tobytes()
        before = trs.bitslice_gf256.launches
        n, cw = trs.encode_payload(card, buf)
        assert trs.bitslice_gf256.launches == before + 1
        np.testing.assert_array_equal(cw, trs.encode_payload(host, buf)[1])
        for sub in SUBSETS:
            held = {i: cw[i] for i in sub}
            assert trs.decode_payload(card, held, n) == buf
    store = CodewordStore(4, card, total=5, device=cuda_device)
    peer = CodewordStore(4, card, total=5, device=cuda_device)
    for j, sub in enumerate(SUBSETS):
        batch = {"ops": [("put", f"k{j}", "v" * (100 + j))]}
        n, rows = store.encode(j % 4, j, batch, spr=1)
        peer.add_shards(j % 4, j, n, {s: rows[s] for s in sub})
        assert peer.reconstruct_batch(j % 4, j) == batch
        assert peer.have_mask(j % 4, j) == 0b11111


# ------------------------------------------------------------ serving path
@pytest.mark.cuda
def test_telemetry_block_follows_cuda_state(cuda_device):
    """The server attaches the lane block after ``init_state`` with no
    ``device``: it must land on the card beside the state."""
    from summerset_tpu_torch.core import telemetry

    kernel = make_protocol("multipaxos", 4, 3, 32, device=cuda_device)
    state = kernel.init_state(seed=0)
    telemetry.attach(state, 4, 3)
    assert state[telemetry.TELEM_KEY].device.type == "cuda"
    assert all(v.device.type == "cuda" for v in state.values())


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_serving_on_card_matches_cpu(cuda_device, tmp_path, pipeline):
    """24 sequential puts on a 1-replica port cluster on the card and on
    the CPU: equal durable digests, KV, floors and WAL records."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cluster import sequential_puts

    card = sequential_puts(tmp_path / "card", "cuda", pipeline)
    cpu = sequential_puts(tmp_path / "cpu", "cpu", pipeline)
    assert sum(card["applied"]) == 24
    for part in ("digest", "kv", "applied", "wal"):
        assert card[part] == cpu[part], part


@pytest.mark.cuda
def test_rspaxos_serving_on_card_matches_cpu(cuda_device, tmp_path):
    """Three RSPaxos replicas on the card against three on the CPU in
    per-tick lockstep through a leader change: equal state, frames, WAL
    records, floors, KV and replies, shard records compared by the batch
    they encode and byte for byte; the card's codec ran
    ``bitslice_gf256`` and its new leader rebuilt values from shards."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cluster import card_cpu_lockstep

    out = card_cpu_lockstep(tmp_path, "cuda")
    assert out["launches"] > 0 and out["rebuilt"] > 0, out
    assert out["shard_frames"] > 0 and len(out["leaders"]) > 1, out


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["QuorumLeases", "Bodega",
                                      "MultiPaxos"])
def test_lease_serving_on_card_matches_cpu(cuda_device, tmp_path, protocol):
    """Three lease-plane replicas on the card against three on the CPU in
    per-tick lockstep through the conf change (QuorumLeases at the
    leader, Bodega at a follower; MultiPaxos with leader leases has none)
    and the first local gets: equal state, frames, WAL records, floors,
    KV and replies with their ``local`` flags; local gets were served at
    the followers (the leader under leader leases)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cluster import card_cpu_lease_lockstep

    out = card_cpu_lease_lockstep(tmp_path, "cuda", protocol)
    if protocol == "MultiPaxos":
        assert out["local"][0] > 0 and out["local"][1:] == [0, 0], out
    else:
        assert out["conf_ok"] == 1 and sum(out["local"][1:]) > 0, out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["EPaxos", "EPaxos-pipelined", "ChainRep",
                                  "SimplePush", "RepNothing"])
def test_every_protocol_serving_on_card_matches_cpu(cuda_device, tmp_path,
                                                    case):
    """Three replicas of each newly served protocol on the card against
    three on the CPU in per-tick lockstep through a durable reset: equal
    state, frames, WAL records (``eapply`` included), floors, KV and
    replies; EPaxos proposed several key buckets of a group in one
    tick."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cluster import card_cpu_serving_lockstep

    protocol = case.split("-")[0]
    out = card_cpu_serving_lockstep(tmp_path, "cuda", protocol,
                                    pipelined=case.endswith("pipelined"))
    assert out["acked"] > 0, out
    if protocol == "EPaxos":
        assert out["multi"] >= 2, out


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_proxy_batch_intake_on_card_matches_cpu(cuda_device, tmp_path,
                                                pipelined):
    """RSPaxos replicas on the card against replicas on the CPU with an
    ingress proxy's ``batch`` forwards in every intake: equal state,
    frames, WAL, floors, KV and per-prid replies, and batch entries
    acked (``chip_smoke.py`` phase 22 (d) at 64 groups)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_cluster import card_cpu_serving_lockstep

    out = card_cpu_serving_lockstep(tmp_path, "cuda", "RSPaxos",
                                    pipelined=pipelined, batch=True)
    assert out["batch_acked"] > 0, out


@pytest.mark.cuda
def test_codec_roundtrip_of_pinned_outbox_frame(cuda_device, tmp_path):
    """A tick frame sliced from a card replica's outbox (host views of its
    pinned prefetch buffers, strided per peer) goes through the wire
    codec's segments and back: every lane equal, decoded from a body the
    encoder built without copying the contiguous lanes."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import summerset_tpu_torch.host.server as tsrv
    import time
    import types

    from summerset_tpu_torch.utils import safetcp, wirecodec
    from test_torch_cluster import FakeNet, build, requests

    from summerset_tpu_torch.host import messages, statemach

    pkg = types.SimpleNamespace(msg=messages, sm=statemach)
    net = FakeNet(3)
    reps = [build(tsrv, "MultiPaxos", r, 3, 64, 32, tmp_path / str(r),
                  {"pipeline": False}, net=net, device="cuda")
            for r in range(3)]
    try:
        for t in range(6):
            for r, rep in enumerate(reps):
                rep.external.batches.append(requests(pkg, t, r))
                rep._tick_serial(time.monotonic())
            net.flush()
        rep = reps[0]
        assert rep._stream is not None
        frames = rep._slice_outbox(rep._last_out)
        enc = wirecodec.FrameEncoder()
        for dst, msg in frames.items():
            frame = (rep.tick, {"msg": msg, "pp": {}, "ts": 0.0})
            segs, total = safetcp.encode_frame_into(frame, enc, codec=True)
            body = b"".join(bytes(s) for s in segs)[8:]
            enc.release()
            assert body[2] == wirecodec.T_TICKFRAME and len(body) + 8 == \
                total
            tick, back = wirecodec.decode_body(body)
            assert tick == rep.tick
            for k, a in msg.items():
                assert back["msg"][k].dtype == a.dtype
                assert np.array_equal(back["msg"][k], a), (dst, k)
    finally:
        for rep in reps:
            rep.shutdown()


@pytest.mark.cuda
def test_near_quorum_read_served_on_card(cuda_device, tmp_path):
    """A live 3-replica MultiPaxos cluster on the card with near-quorum
    reads (the codec on, the native WAL): a follower answers a get of an
    acked key by quorum (``local``), with the acked value."""
    import os
    import sys
    import time

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from summerset_tpu_torch.client.drivers import DriverClosedLoop
    from summerset_tpu_torch.client.endpoint import GenericEndpoint
    from summerset_tpu_torch.cluster import Cluster

    c = Cluster("MultiPaxos", 3, tmp_path, num_groups=8, device="cuda",
                config={"near_quorum_reads": True})
    try:
        ep = c.endpoint()
        drv = DriverClosedLoop(ep, timeout=5.0)
        drv.checked_put("nqr_card", "v1", retries=40)
        leader = c.leader_of(0)
        follower = next(s for s in sorted(c.replicas) if s != leader)
        ep2 = GenericEndpoint(c.manager_addr, server_id=follower)
        ep2.connect()
        drv2 = DriverClosedLoop(ep2, timeout=5.0)
        got = None
        for _ in range(40):
            r = drv2.get("nqr_card")
            if r.kind == "success" and r.local:
                got = r
                break
            ep2.reconnect(follower)
            time.sleep(0.2)
        ep2.leave()
        ep.leave()
        assert got is not None and got.result.value == "v1"
        assert all(rep.wal.native and rep.wire_codec
                   for rep in c.replicas.values())
    finally:
        c.stop()
    assert not c.faults(), c.faults()


# ------------------------------------------------ observability planes
@pytest.mark.cuda
def test_snapshot_row_on_card_matches_cpu(cuda_device):
    """The scrape's decode of one replica's ``[G, K]`` lane block: a block
    on the card decodes equal to the same block on the CPU (one row
    crosses), with and without the per-group matrix."""
    from summerset_tpu_torch.core import telemetry

    rng = np.random.default_rng(5)
    for G in (8, 100):
        block = torch.from_numpy(rng.integers(
            0, 2 ** 30, size=(G, 3, telemetry.K), dtype=np.int32))
        for me in range(3):
            want = telemetry.snapshot_row(block, me)
            assert telemetry.snapshot_row(block.to(cuda_device), me) == want
            assert telemetry.snapshot_row(block.numpy(), me) == want


@pytest.mark.cuda
def test_metrics_snapshot_on_card_matches_cpu(cuda_device, tmp_path):
    """Three MultiPaxos replicas on the card against three on the CPU in
    per-tick lockstep with the flight recorder, slot traces and
    graftwatch on: every card replica's ``metrics_snapshot`` (read from
    the pinned view of its last retired step) is JSON-able, its device
    lanes equal the CPU replica's after the same ticks, and so do its
    slot traces and deterministic counters."""
    import json
    import os
    import sys
    import types

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import summerset_tpu_torch.host.server as srv
    from summerset_tpu_torch.host import messages, statemach
    from test_torch_cluster import (
        CARD_CPU_CFG, lockstep_sides, lockstep_tick, shutdown_sides,
    )

    pkg = types.SimpleNamespace(msg=messages, sm=statemach)
    cfg = dict(CARD_CPU_CFG, health_enabled=False, flight_record=True,
               trace_sample=2, graftwatch=True, watch_ticks=5)
    sides = lockstep_sides(tmp_path, "MultiPaxos", (
        ("card", srv, pkg, trs.encode_payload, {"device": cuda_device}),
        ("cpu", srv, pkg, trs.encode_payload, {"device": "cpu"}),
    ), cfg, 16, 3, 32)
    try:
        for t in range(30):
            seen = lockstep_tick(sides, t, mute=0 if 10 <= t < 18 else None,
                                 port_sides=("card", "cpu"))
            for part in ("state", "wal", "replies", "kv"):
                assert seen["card"][part] == seen["cpu"][part], (t, part)
        got = {}
        for name, (reps, *_rest) in sides.items():
            snaps = [rep.metrics_snapshot() for rep in reps]
            for s in snaps:
                json.dumps(s)
            got[name] = [(s["device"], s["applied"],
                          [{k: v for k, v in tr.items() if k != "latency_ms"}
                           for tr in s["traces"]],
                          {k: s["host"]["counters"][k] for k in
                           ("commits_applied_total", "wal_appends_total",
                            "watch_frames_total", "leader_demotions")})
                         for s in snaps]
        assert got["card"] == got["cpu"]
        assert got["card"][0][0]["lanes"]["commits"] > 0
    finally:
        shutdown_sides(sides)


@pytest.mark.cuda
def test_compiled_plan_on_card_matches_cpu(cuda_device):
    """``chip_smoke.py`` phase 21 (a) at 64 groups: seed 11's nemesis
    plan compiled on the card drives RSPaxos 64x5 (W=128, P=32) through
    the plan and a 200-tick heal; every leaf equals the same run on the
    CPU given the same masks, every replica ends within 4P of its
    group's leader, and the heal's last-tick values encode and rebuild
    through ``bitslice_gf256`` on the card."""
    from summerset_tpu_torch.host.nemesis import FaultPlan

    G, R, W, P = 64, 5, 128, 32
    plan = FaultPlan.generate(
        11, R, 160, classes=("crash", "device_reset", "pause", "partition",
                             "isolate", "one_way", "drop", "clock_skew"))
    masks = plan.compile_device(G, device=cuda_device)
    assert all(m.device.type == "cuda" for m in masks.values())
    out = {}
    for dev in (cuda_device, "cpu"):
        cfg = ReplicaConfigRSPaxos(max_proposals_per_tick=P,
                                   chunk_size=2 * P,
                                   exec_follows_commit=False,
                                   fault_tolerance=1)
        eng = Engine(make_protocol("rspaxos", G, R, W, cfg, device=dev),
                     device=dev)
        st, ns = eng.init()
        for lo in range(0, 360, 40):
            t = torch.arange(lo, lo + 40, dtype=torch.int32)
            seq = {"n_proposals": torch.full((40, G), P, dtype=torch.int32),
                   "value_base": (t * P)[:, None].expand(40, G),
                   "exec_floor": torch.full((40, G, R), 1 << 30,
                                            dtype=torch.int32)}
            if lo < 160:
                seq.update({k: v[lo:lo + 40].to(dev)
                            for k, v in masks.items()})
            st, ns, fx = eng.run_ticks(st, ns, seq, collect=True)
        out[str(dev)] = (st, _digest({"state": to_numpy(st),
                                      "net": to_numpy(ns)}), fx)
    assert out["cpu"][1] == out[str(cuda_device)][1]
    st, _d, fx = out[str(cuda_device)]
    cb = st["commit_bar"]
    assert int((cb.amax(dim=1) - cb.amin(dim=1)).max()) <= 4 * P
    n_acc = fx.extra["n_accepted"][-1].amax(dim=1).cpu().numpy()
    B = int(n_acc.sum())
    assert B > 0
    code = trs.RSCode(3, 2, device=cuda_device)
    data = torch.from_numpy(_lanes(21, (B, 3, 344))).to(cuda_device)
    before = trs.bitslice_gf256.launches
    parity = code.compute_parity(data)
    assert trs.bitslice_gf256.launches == before + 1
    assert torch.equal(parity, trs._bitslice_matmul_plain(
        code._parity_tbl, data))
    cw = torch.cat([data, parity], dim=1)
    for s in SUBSETS[:3]:
        got = code.reconstruct_data(cw[:, list(s)].contiguous(), s)
        assert torch.equal(got, data)
