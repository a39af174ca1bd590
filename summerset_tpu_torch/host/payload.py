"""PayloadStore: host-side value-id <-> request-batch storage, counterpart
of ``summerset_tpu/host/payload.py`` (same vid minting).

The device kernels commit int32 *references*; actual request batches
(client id, request id, commands — up to 16MB values in the reference)
never touch HBM (SURVEY.md §7 hard part (b)).  This store assigns dense
per-group value ids and resolves them at execution time.

The id space mirrors the synthetic-load convention used by the kernels'
bench mode (``value_base`` input): ids are positive, 0 is reserved for the
no-op filler (``protocols/common.py`` NULL_VAL).

This store holds only *full* request batches; the codeword plane keeps
shard subsets beside it in ``host/codeword.py::CodewordStore``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class PayloadStore:
    def __init__(self, num_groups: int = 1):
        self._lock = threading.Lock()
        self._next = [1] * num_groups
        self._data: list[Dict[int, Any]] = [dict() for _ in range(num_groups)]

    def put(self, group: int, batch: Any, stride: int = 1,
            residue: int = 0) -> int:
        """Store a request batch, returning its value id (>= 1).

        ``stride``/``residue`` partition the id space between concurrent
        proposers (one residue class per replica): without this, two
        servers proposing in the same tick mint the same id for
        different batches and the payload exchange silently cross-wires
        them (first-writer-wins at every peer)."""
        with self._lock:
            # _next starts at 1 and only grows, and the residue bump is
            # non-negative, so vid >= 1 always holds (0 stays the no-op)
            vid = self._next[group]
            if stride > 1:
                vid += (residue - vid) % stride
            self._next[group] = vid + 1
            self._data[group][vid] = batch
        return vid

    def get(self, group: int, vid: int) -> Optional[Any]:
        if vid == 0:
            return None  # no-op filler
        with self._lock:
            return self._data[group].get(vid)

    def install(self, group: int, vid: int, batch: Any,
                overwrite: bool = True) -> None:
        """Install a batch under a peer-minted / reconstructed vid,
        keeping the local minting cursor past it (first-writer-wins when
        ``overwrite`` is False, the payload-exchange dedup rule)."""
        with self._lock:
            if overwrite or vid not in self._data[group]:
                self._data[group][vid] = batch
            self._next[group] = max(self._next[group], vid + 1)

    def note_seen(self, group: int, vid: int) -> None:
        """Bump the minting cursor past an externally observed vid
        (shard-only ingests hold no batch to install)."""
        with self._lock:
            self._next[group] = max(self._next[group], vid + 1)
