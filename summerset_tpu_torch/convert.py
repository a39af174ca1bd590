"""Carry engine state across between the JAX package and the port.

The JAX ``(state, netstate)`` pytrees, given as nested dicts of numpy
arrays, become nested dicts of torch tensors on ``device`` and back.
Leaf names, shapes and byte widths are unchanged: uint32 leaves become
int32 tensors with the same bits and return as uint32.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import resolve_device

#: leaves the JAX package holds as uint32 (bitmaps, flags, LCG states)
UINT32_LEAVES = frozenset({"flags", "grants", "prep_acks", "prep_voters",
                           "rng"})


def to_torch(tree: Mapping[str, Any], device=None) -> dict:
    """Nested dict of numpy arrays (JAX layout) -> nested dict of tensors."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = to_torch(v, dev)
            continue
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype not in (np.int32, np.bool_, np.float32):
            raise TypeError(f"leaf {k!r}: unsupported dtype {a.dtype}")
        out[k] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return out


def to_numpy(tree: Mapping[str, Any]) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays in the JAX
    layout (``UINT32_LEAVES`` reinterpreted back to uint32)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = to_numpy(v)
            continue
        a = v.detach().cpu().numpy()
        if k in UINT32_LEAVES:
            if a.dtype != np.int32:
                raise TypeError(f"leaf {k!r}: expected int32, got {a.dtype}")
            a = a.view(np.uint32)
        out[k] = a
    return out
