"""Per-(group, replica) LCG PRNG, bit-identical to ``summerset_tpu.ops.prng``.

The JAX reference keeps uint32 LCG states.  torch has no ``+``, ``>>``,
``%`` or comparisons on uint32, so the lanes are int32 tensors holding the
same 32 bits: the multiply-add wraps modulo 2^32 identically, and every
logical right shift is written ``(x >> 8) & 0xFFFFFF`` because int32 ``>>``
is arithmetic.  This is the only generator in the port: there is no
global RNG.
"""

from __future__ import annotations

import numpy as np
import torch

_MULT = 1664525
_INC = 1013904223
_SEED_MULT = 2654435761


def _as_i32(v: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def seed_state(seed: int, shape, device="cpu") -> torch.Tensor:
    """Deterministic distinct seeds for an array of generators: generator
    ``i`` (flat index) starts at ``(i * 2654435761 + seed) | 1`` mod 2^32."""
    n = int(np.prod(shape, dtype=np.int64))
    base = np.arange(n, dtype=np.uint64)
    st = ((base * np.uint64(_SEED_MULT) + np.uint64(seed & 0xFFFFFFFF))
          & np.uint64(0xFFFFFFFF)) | np.uint64(1)
    st = st.astype(np.uint32).view(np.int32).reshape(tuple(shape))
    return torch.from_numpy(st.copy()).to(device)


def lcg_next(state: torch.Tensor) -> torch.Tensor:
    return state * _MULT + _as_i32(_INC)


def _high24(nxt: torch.Tensor) -> torch.Tensor:
    """The logical ``nxt >> 8`` of the uint32 reading: 24 bits, >= 0."""
    return (nxt >> 8) & 0xFFFFFF


def uniform_int(state: torch.Tensor, lo: int, hi: int):
    """Draw ints in [lo, hi) elementwise; returns (new_state, draws)."""
    nxt = lcg_next(state)
    span = max((hi - lo) & 0xFFFFFFFF, 1)
    draw = torch.remainder(_high24(nxt), span)
    return nxt, draw + lo


def uniform_unit(state: torch.Tensor):
    """Draw float32s in [0, 1); returns (new_state, draws)."""
    nxt = lcg_next(state)
    return nxt, _high24(nxt).to(torch.float32) * (1.0 / (1 << 24))
