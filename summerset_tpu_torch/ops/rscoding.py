"""GF(2^8) Reed-Solomon erasure coding, counterpart of
``summerset_tpu/ops/rscoding.py``.

The field arithmetic is the reference's bit-sliced GF(2^8) matrix product
on int32 lanes (4 shard bytes per lane, little-endian): multiplying a
byte by a constant is GF(2)-linear, so ``c * x = XOR_{bit i of x} c*2^i``,
and ``((x >> i) & 0x01010101) * tbl[r, c, i]`` places the byte ``c*2^i``
in exactly the bytes whose bit ``i`` is set.

:func:`bitslice_gf256` is the one entry to that product: on a CUDA tensor
it launches the hand-written kernel ``csrc/bitslice.cu`` (counting the
launch), on a CPU tensor it runs the plain PyTorch version
:func:`_bitslice_matmul_plain`.  It never falls back from one to the
other: a failed build or launch raises.

The encode matrix is systematic ``[I; C]`` with an extended Cauchy parity
block (MDS: any ``d`` of ``d + p`` shards reconstruct).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import native

# ---------------------------------------------------------------- GF tables --
_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


def _build_tables() -> Tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(2^8) multiply (host)."""
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_matmul_host(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Host GF(2^8) matrix product (small matrices; reference oracle)."""
    n, k = A.shape
    k2, m = B.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {k} vs {k2}")
    out = np.zeros((n, m), np.uint8)
    for i in range(n):
        for j in range(m):
            acc = 0
            for t in range(k):
                acc ^= gf_mul(int(A[i, t]), int(B[t, j]))
            out[i, j] = acc
    return out


def gf_inv_matrix_host(M: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8) (host, small d)."""
    d = M.shape[0]
    aug = np.concatenate(
        [M.astype(np.uint8), np.eye(d, dtype=np.uint8)], axis=1
    )
    for col in range(d):
        piv = next(
            (r for r in range(col, d) if aug[r, col] != 0), None
        )
        if piv is None:
            raise ValueError("singular matrix over GF(2^8)")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = [gf_mul(int(v), inv_p) for v in aug[col]]
        for r in range(d):
            if r != col and aug[r, col] != 0:
                f = int(aug[r, col])
                aug[r] ^= np.array(
                    [gf_mul(f, int(v)) for v in aug[col]], np.uint8
                )
    return aug[:, d:]


def build_encode_matrix(num_data: int, num_parity: int) -> np.ndarray:
    """Systematic [I; C] encode matrix, C[i, j] = 1 / ((d + i) ^ j)."""
    if num_data + num_parity > 256:
        raise ValueError("d + p must be <= 256 for GF(2^8)")
    C = np.zeros((num_parity, num_data), np.uint8)
    for i in range(num_parity):
        for j in range(num_data):
            C[i, j] = gf_inv((num_data + i) ^ j)
    return np.concatenate([np.eye(num_data, dtype=np.uint8), C], axis=0)


# ------------------------------------------------- bit-sliced coefficients --
def _bitslice_coeffs(M: np.ndarray) -> np.ndarray:
    """[rows, cols] GF coeff matrix -> [rows, cols, 8] int32 table of
    ``M[r, c] * 2^i`` (each a byte)."""
    rows, cols = M.shape
    t = np.zeros((rows, cols, 8), np.int32)
    for r in range(rows):
        for c in range(cols):
            for i in range(8):
                t[r, c, i] = gf_mul(int(M[r, c]), 1 << i)
    return t


_LANE_ONES = 0x01010101


def _bitslice_matmul_plain(tbl: torch.Tensor, shards: torch.Tensor
                           ) -> torch.Tensor:
    """The plain PyTorch version: ``tbl`` [rows, cols, 8] int32,
    ``shards`` [..., cols, L] int32 -> [..., rows, L] int32.  The int32
    products wrap exactly as the JAX version's do."""
    rows, cols, _ = tbl.shape
    coef = tbl.tolist()
    out = []
    for r in range(rows):
        acc = torch.zeros(shards.shape[:-2] + shards.shape[-1:],
                          dtype=torch.int32, device=shards.device)
        for c in range(cols):
            x = shards[..., c, :]
            for i in range(8):
                acc = acc ^ (((x >> i) & _LANE_ONES) * coef[r][c][i])
        out.append(acc)
    return torch.stack(out, dim=-2)


# --------------------------------------------------------------- CUDA path --
_SMEM_TABLE_LIMIT = 48 * 1024  # bytes of table the kernel stages in shared memory


_BITSLICE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # tbl, x, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,       # B, rows, cols
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,    # L, device, stream
]


def _bitslice_lib():
    fn = native.load("bitslice").bitslice_gf256
    # ctypes passes undeclared ints as 32-bit: declare every argument so
    # pointers and 64-bit sizes arrive whole
    fn.argtypes = _BITSLICE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _bitslice_cuda(tbl: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/bitslice.cu`` on the current stream: ``tbl``
    [rows, cols, 8], ``shards`` [B, cols, L], both int32, contiguous, on
    one CUDA device."""
    if tbl.device != shards.device:
        raise ValueError(f"tbl on {tbl.device}, shards on {shards.device}")
    if tbl.dtype != torch.int32 or shards.dtype != torch.int32:
        raise TypeError("bitslice_gf256 takes int32 tbl and shards")
    if tbl.ndim != 3 or tbl.shape[2] != 8:
        raise ValueError(f"tbl must be [rows, cols, 8], got {tuple(tbl.shape)}")
    rows, cols = int(tbl.shape[0]), int(tbl.shape[1])
    if shards.ndim != 3 or shards.shape[1] != cols:
        raise ValueError(
            f"shards must be [B, {cols}, L], got {tuple(shards.shape)}"
        )
    if not (tbl.is_contiguous() and shards.is_contiguous()):
        raise ValueError("bitslice_gf256 takes contiguous tensors")
    if rows * cols * 8 * 4 > _SMEM_TABLE_LIMIT:
        raise ValueError(f"table [{rows}, {cols}, 8] exceeds shared memory")
    B, _, L = shards.shape
    out = torch.empty((B, rows, L), dtype=torch.int32, device=shards.device)
    if out.numel() == 0:
        return out  # nothing to launch
    fn = _bitslice_lib()
    stream = torch.cuda.current_stream(shards.device).cuda_stream
    err = fn(tbl.data_ptr(), shards.data_ptr(), out.data_ptr(), B, rows,
             cols, L, shards.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"bitslice_gf256 launch failed: cudaError {err}")
    bitslice_gf256.launches += 1
    return out


def bitslice_gf256(tbl: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """GF(2^8) product ``[..., cols, L] -> [..., rows, L]`` under the
    bit-sliced table ``tbl`` [rows, cols, 8]: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if shards.device.type != "cuda":
        return _bitslice_matmul_plain(tbl, shards)
    lead = shards.shape[:-2]
    flat = shards.reshape((-1,) + tuple(shards.shape[-2:])).contiguous()
    out = _bitslice_cuda(tbl.contiguous(), flat)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


#: launches of the CUDA kernel in this process (the plain version on CPU
#: tensors does not count)
bitslice_gf256.launches = 0


# ------------------------------------------------------------------- RSCode --
class RSCode:
    """Batched GF(2^8) Reed-Solomon codec for scheme ``(d, p)``.

    Shards are ``[..., shard, L]`` int32 tensors with 4 packed bytes per
    lane.  Which arithmetic runs follows the tensors: the kernel on the
    card, the plain version on the CPU.  The CUDA kernel takes any ``L``
    (a masked tail), so both devices use one lane geometry: the JAX
    codec's on the CPU (``use_pallas`` off), whose TPU kernel alone needs
    128-lane rows."""

    def __init__(self, num_data: int, num_parity: int, device=None):
        self.d = num_data
        self.p = num_parity
        self.device = resolve_device(device)
        self.matrix = build_encode_matrix(num_data, num_parity)
        self._parity_tbl = torch.from_numpy(
            _bitslice_coeffs(self.matrix[num_data:])
        ).to(self.device)
        self._decode_cache = {}

    # -- encode ----------------------------------------------------------
    def compute_parity(self, data: torch.Tensor) -> torch.Tensor:
        """[..., d, L] int32 -> [..., p, L] parity shards."""
        if self.p == 0:
            return data[..., :0, :]
        return bitslice_gf256(self._parity_tbl, data)

    # -- verify ----------------------------------------------------------
    def verify_parity(self, data: torch.Tensor, parity: torch.Tensor):
        """Recompute and compare: [...] bool per codeword."""
        want = self.compute_parity(data)
        return (want == parity).all(dim=-1).all(dim=-1)

    # -- decode ----------------------------------------------------------
    def _decode_tbl(self, present: Tuple[int, ...]) -> torch.Tensor:
        """Decode table mapping d present shards -> d data shards."""
        key = tuple(present)
        if key not in self._decode_cache:
            if len(key) != self.d:
                raise ValueError(f"need exactly {self.d} present shards")
            inv = gf_inv_matrix_host(self.matrix[list(key)])
            self._decode_cache[key] = torch.from_numpy(
                _bitslice_coeffs(inv)
            ).to(self.device)
        return self._decode_cache[key]

    def reconstruct_data(self, shards: torch.Tensor,
                         present: Tuple[int, ...]) -> torch.Tensor:
        """Recover the d data shards from any d available shards;
        ``shards`` [..., d, L] holds the ``present`` shard ids in order."""
        if shards.shape[-2] != self.d:
            raise ValueError(
                f"shards axis -2 must hold exactly the {self.d} present "
                f"shards (got {shards.shape[-2]})"
            )
        return bitslice_gf256(self._decode_tbl(tuple(present)), shards)

    def reconstruct_all(self, shards: torch.Tensor,
                        present: Tuple[int, ...]) -> torch.Tensor:
        """Data + parity from any d shards."""
        data = self.reconstruct_data(shards, present)
        return torch.cat([data, self.compute_parity(data)], dim=-2)


# ----------------------------------------------------------- byte utilities --
def pack_bytes(buf: bytes, num_data: int, lane_multiple: int = 1
               ) -> np.ndarray:
    """Split a byte string into d equal zero-padded shards, packed [d, L]
    int32 (little-endian lanes); ``lane_multiple`` rounds L up further."""
    shard_len = -(-len(buf) // num_data)
    shard_len = -(-shard_len // 4) * 4
    if lane_multiple > 1:
        q = 4 * lane_multiple
        shard_len = -(-shard_len // q) * q
    padded = np.zeros(num_data * shard_len, np.uint8)
    padded[: len(buf)] = np.frombuffer(buf, np.uint8)
    return (
        padded.reshape(num_data, shard_len // 4, 4)
        .view("<u4")[..., 0]
        .view(np.int32)
        .copy()
    )


def unpack_bytes(shards: np.ndarray, data_len: int) -> bytes:
    """Inverse of :func:`pack_bytes` given the original byte length."""
    u = np.ascontiguousarray(np.asarray(shards), dtype="<i4")
    return u.view(np.uint8).reshape(-1).tobytes()[:data_len]


# -------------------------------------------------- serving entry points --
def encode_payload(code: RSCode, buf: bytes) -> Tuple[int, np.ndarray]:
    """Serialized payload -> ``(data_len, [d + p, L] int32 codeword)``;
    rows ``[0, d)`` are the data split (``L`` lanes of 4 bytes, the last
    row zero-padded), ``[d, d + p)`` parity, on every device alike."""
    data = pack_bytes(buf, code.d)
    if code.p == 0:
        return len(buf), data
    dev_data = torch.from_numpy(data).to(code.device)
    parity = code.compute_parity(dev_data[None])[0].cpu().numpy()
    return len(buf), np.concatenate([data, parity], axis=0)


def decode_rows(code: RSCode, shards: dict) -> np.ndarray:
    """Any ``d`` held shards ``{shard id: [L] int32}`` -> the ``d`` data
    rows ``[d, L]``: identity rows when ``[0, d)`` are all held, else the
    cached decode table through the codec."""
    d = code.d
    if len(shards) < d:
        raise ValueError(f"need {d} shards, have {len(shards)}")
    if all(i in shards for i in range(d)):
        return np.stack([np.asarray(shards[i]) for i in range(d)])
    present = tuple(sorted(shards))[:d]
    stacked = np.stack([np.asarray(shards[i]) for i in present])
    dev = torch.from_numpy(np.ascontiguousarray(stacked, np.int32))
    return code.reconstruct_data(dev.to(code.device), present).cpu().numpy()


def decode_payload(code: RSCode, shards: dict, data_len: int) -> bytes:
    """Any ``d`` held shards ``{shard id: [L] int32}`` -> payload bytes."""
    return unpack_bytes(decode_rows(code, shards), data_len)
