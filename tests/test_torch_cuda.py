"""The port on the card: the GF(2^8) CUDA kernel against its plain PyTorch
version, and the card's engine and codec against the port on the CPU.

Every test here needs an NVIDIA card and ``nvcc`` and skips elsewhere.
The file imports neither ``jax`` nor the JAX package, so it also runs on a
GPU machine without them, skipping ``tests/conftest.py`` (which imports
jax):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py

Tolerance: exact.  Every compared value is an integer, and the kernel
repeats the plain version's wrapping int32 arithmetic.
"""

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
from summerset_tpu_torch.protocols.multipaxos import ReplicaConfigMultiPaxos
from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos

SUBSETS = list(itertools.combinations(range(5), 3))


def _tables():
    """The parity tables of RS(3,2), RS(2,1), RS(5,3) and the ten 3-of-5
    decode tables of RS(3,2)."""
    out = {}
    for d, p in ((3, 2), (2, 1), (5, 3)):
        out[f"enc{d}{p}"] = trs._bitslice_coeffs(
            trs.build_encode_matrix(d, p)[d:])
    M = trs.build_encode_matrix(3, 2)
    for s in SUBSETS:
        out[f"dec{s}"] = trs._bitslice_coeffs(
            trs.gf_inv_matrix_host(M[list(s)]))
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


@pytest.mark.cuda
@pytest.mark.parametrize("proto", ["multipaxos", "rspaxos"])
def test_engine_on_card_matches_cpu(proto, cuda_device):
    G, R, W, P, T = 8, 5, 32, 4, 16
    fast = dict(max_proposals_per_tick=P, hear_timeout_lo=5,
                hear_timeout_hi=9, tally="collective")
    net = NetConfig(delay_ticks=1, jitter_ticks=1, drop_rate=0.05,
                    max_delay_ticks=3)
    digests = {}
    for dev in ("cpu", cuda_device):
        cfg = (ReplicaConfigMultiPaxos(**fast) if proto == "multipaxos"
               else ReplicaConfigRSPaxos(fault_tolerance=1, **fast))
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


@pytest.mark.cuda
def test_codec_on_card_matches_cpu(cuda_device):
    card = trs.RSCode(3, 2, device=cuda_device)
    host = trs.RSCode(3, 2, use_kernel=True, device="cpu")
    assert card.use_kernel
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
