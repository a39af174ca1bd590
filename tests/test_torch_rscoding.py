"""The port's GF(2^8) Reed-Solomon codec against the JAX package
(``summerset_tpu_torch/ops/rscoding.py``, ``host/codeword.py``).

On the CPU the kernel wrapper runs the plain PyTorch version; it must be
byte-identical to the JAX jnp path, to the JAX Pallas kernel run in
interpret mode, and to the host byte oracle.  The kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import functools
import itertools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summerset_tpu.host import codeword as jcw
from summerset_tpu.ops import rscoding as jrs
from summerset_tpu_torch.host import codeword as tcw
from summerset_tpu_torch.ops import rscoding as trs

SUBSETS = list(itertools.combinations(range(5), 3))


def _tables():
    """Every table the RSPaxos path uses: the parity tables of the three
    schemes and the ten 3-of-5 decode tables."""
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


def test_gf_tables_match_jax():
    np.testing.assert_array_equal(trs.GF_EXP, jrs.GF_EXP)
    np.testing.assert_array_equal(trs.GF_LOG, jrs.GF_LOG)
    for d, p in ((3, 2), (2, 1), (5, 3), (4, 0)):
        np.testing.assert_array_equal(
            trs.build_encode_matrix(d, p), jrs.build_encode_matrix(d, p))
    for name, tbl in TABLES.items():
        assert tbl.dtype == np.int32 and tbl.shape[2] == 8, name


@pytest.mark.parametrize("name", sorted(TABLES))
def test_plain_matches_jnp(name):
    tbl = TABLES[name]
    cols = tbl.shape[1]
    x = _lanes(len(name), (2, 3, cols, 40))  # two batch dims
    want = np.asarray(jrs._bitslice_matmul_jnp(jnp.asarray(tbl),
                                               jnp.asarray(x)))
    got = trs.bitslice_gf256(torch.from_numpy(tbl), torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_pallas_interpret():
    from jax.experimental import pallas as pl

    tbl = TABLES["enc32"]
    data = _lanes(13, (4, 3, 256))
    out = pl.pallas_call(
        functools.partial(jrs._bitslice_kernel, rows=2, cols=3),
        out_shape=jax.ShapeDtypeStruct((4, 2, 256), np.int32),
        grid=(4, 2),
        in_specs=[
            pl.BlockSpec((2, 3, 8), lambda b, l: (0, 0, 0)),
            pl.BlockSpec((1, 3, 128), lambda b, l: (b, 0, l)),
        ],
        out_specs=pl.BlockSpec((1, 2, 128), lambda b, l: (b, 0, l)),
        interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(data))
    got = trs._bitslice_matmul_plain(torch.from_numpy(tbl),
                                     torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))


def test_cpu_tensors_never_launch():
    before = trs.bitslice_gf256.launches
    trs.bitslice_gf256(torch.from_numpy(TABLES["enc32"]),
                       torch.from_numpy(_lanes(1, (3, 8))))
    assert trs.bitslice_gf256.launches == before


@pytest.mark.parametrize("bad", ["dtype", "tbl_shape", "cols", "ndim",
                                 "contiguous"])
def test_kernel_wrapper_rejects(bad):
    """The CUDA wrapper validates before it loads or launches anything."""
    tbl = torch.from_numpy(TABLES["enc32"])
    x = torch.from_numpy(_lanes(2, (2, 3, 16)))
    if bad == "dtype":
        x, exc = x.to(torch.int64), TypeError
    elif bad == "tbl_shape":
        tbl, exc = tbl[..., :4], ValueError
    elif bad == "cols":
        x, exc = x[:, :2], ValueError
    elif bad == "ndim":
        x, exc = x[0], ValueError
    else:
        x, exc = x.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    with pytest.raises(exc):
        trs._bitslice_cuda(tbl, x)


@pytest.mark.parametrize("d,p", [(3, 2), (2, 1), (5, 3), (4, 0)])
def test_parity_matches_byte_oracle(d, p):
    code = trs.RSCode(d, p, use_kernel=False, device="cpu")
    rng = np.random.default_rng(d * 10 + p)
    raw = rng.integers(0, 256, size=(d, 32), dtype=np.uint8)
    data = torch.from_numpy(trs.pack_bytes(raw.tobytes(), d))
    parity = code.compute_parity(data).numpy()
    got = np.frombuffer(
        trs.unpack_bytes(parity, p * 32), np.uint8
    ).reshape(p, 32) if p else np.zeros((0, 32), np.uint8)
    P = code.matrix[d:]
    want = np.zeros((p, 32), np.uint8)
    for i in range(p):
        for j in range(d):
            want[i] ^= np.array(
                [trs.gf_mul(int(P[i, j]), int(b)) for b in raw[j]], np.uint8)
    np.testing.assert_array_equal(got, want)
    jcode = jrs.RSCode(d, p, use_pallas=False)
    np.testing.assert_array_equal(
        parity, np.asarray(jcode.compute_parity(data.numpy())))


@pytest.mark.parametrize("present", SUBSETS)
def test_reconstruct_from_any_quorum(present):
    code = trs.RSCode(3, 2, use_kernel=False, device="cpu")
    data = torch.from_numpy(_lanes(sum(present), (2, 3, 16)))
    full = torch.cat([data, code.compute_parity(data)], dim=-2)
    got = code.reconstruct_data(full[:, list(present)], present)
    assert torch.equal(got, data)
    assert torch.equal(code.reconstruct_all(full[:, list(present)], present),
                       full)
    jcode = jrs.RSCode(3, 2, use_pallas=False)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jcode.reconstruct_data(
            full[:, list(present)].numpy(), present)))


def test_verify_parity_detects_corruption():
    code = trs.RSCode(3, 2, use_kernel=False, device="cpu")
    data = torch.from_numpy(_lanes(11, (4, 3, 8)))
    parity = code.compute_parity(data)
    assert code.verify_parity(data, parity).tolist() == [True] * 4
    bad = parity.clone()
    bad[2, 0, 3] ^= 0x40
    assert code.verify_parity(data, bad).tolist() == [True, True, False, True]


@pytest.mark.parametrize("size", [0, 1, 37, 4096, 70001])
@pytest.mark.parametrize("kernel_geometry", [False, True])
def test_payload_codec_byte_identical(size, kernel_geometry):
    buf = np.random.default_rng(size).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()
    tcode = trs.RSCode(3, 2, use_kernel=kernel_geometry, device="cpu")
    jcode = jrs.RSCode(3, 2, use_pallas=False)
    tlen, tcw_ = trs.encode_payload(tcode, buf)
    if kernel_geometry:
        # the kernel geometry is the JAX use_pallas one: 128-lane padding,
        # parity of the padded rows
        data = jrs.pack_bytes(buf, 3, lane_multiple=128)
        want = np.concatenate(
            [data, np.asarray(jcode.compute_parity(data))], axis=0)
        assert tcw_.shape[1] % 128 == 0
    else:
        want = jrs.encode_payload(jcode, buf)[1]
    assert tlen == len(buf)
    assert tcw_.dtype == np.int32
    np.testing.assert_array_equal(tcw_, want)
    for sub in SUBSETS:
        held = {i: tcw_[i] for i in sub}
        assert trs.decode_payload(tcode, held, tlen) == buf
        np.testing.assert_array_equal(
            trs.decode_rows(tcode, held), jrs.decode_rows(jcode, held))


def test_codeword_store_matches_jax():
    tcode = trs.RSCode(3, 2, use_kernel=False, device="cpu")
    jcode = jrs.RSCode(3, 2, use_pallas=False)
    tstore = tcw.CodewordStore(4, tcode, total=5, device="cpu")
    jstore = jcw.CodewordStore(4, jcode, total=5)
    tpeer = tcw.CodewordStore(4, tcode, total=5, device="cpu")
    jpeer = jcw.CodewordStore(4, jcode, total=5)
    for j, sub in enumerate(SUBSETS):
        g, vid = j % 4, 100 + j
        # one payload length, so the JAX side compiles one shape
        batch = {"ops": [("put", f"k{j:02d}", "v" * 300)], "n": j}
        tl, trows = tstore.encode(g, vid, batch, spr=1)
        jl, jrows = jstore.encode(g, vid, batch, spr=1)
        assert tl == jl
        np.testing.assert_array_equal(trows, jrows)
        assert tstore.encode(g, vid, batch, spr=1)[0] == tl  # cached
        tpeer.add_shards(g, vid, tl, {s: trows[s] for s in sub[:2]},
                         assigned=True)
        jpeer.add_shards(g, vid, jl, {s: jrows[s] for s in sub[:2]},
                         assigned=True)
        assert tpeer.reconstruct_batch(g, vid) is None
        assert not tpeer.can_reconstruct(g, vid)
        assert tpeer.wal_shards(g, vid, sub[0])[1].keys() == set(sub[:2])
        tpeer.add_shards(g, vid, tl, {sub[2]: trows[sub[2]]})
        jpeer.add_shards(g, vid, jl, {sub[2]: jrows[sub[2]]})
        assert tpeer.have_mask(g, vid) == jpeer.have_mask(g, vid)
        got = tpeer.reconstruct_batch(g, vid)
        assert got == batch == jpeer.reconstruct_batch(g, vid)
        assert tpeer.have_mask(g, vid) == 0b11111
        for s in range(5):
            np.testing.assert_array_equal(
                tpeer.shards_for(g, vid)[1][s], jpeer.shards_for(g, vid)[1][s])
        t_w, j_w = tstore.wal_shards(g, vid, 2), jstore.wal_shards(g, vid, 2)
        assert t_w[0] == j_w[0] and t_w[1].keys() == j_w[1].keys()
    assert tstore.gc_below(0, 104) == jstore.gc_below(0, 104)
    assert tstore.size(0) == jstore.size(0)
    assert pickle.loads(pickle.dumps(tcw.assigned_sids(3, 2, 1, 5))) == \
        jcw.assigned_sids(3, 2, 1, 5)
