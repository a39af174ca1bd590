"""CodewordStore: the host-side sharded codeword payload plane, counterpart
of ``summerset_tpu/host/codeword.py`` (see its module doc).

The store owns the shard bytes keyed by ``(group, value id)`` as numpy
rows; encoding and decoding go through the port's :class:`RSCode`, whose
GF(2^8) products run on the CUDA kernel when the codec lives on the card.
Assignment geometry: replica ``r`` owns shards ``[r * dj, r * dj + spr)
mod T``; RSPaxos is ``dj = 1, T = R, spr = 1``.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.rscoding import (
    RSCode,
    decode_rows,
    encode_payload,
    unpack_bytes,
)


def assigned_sids(replica: int, spr: int, dj: int, total: int
                  ) -> Tuple[int, ...]:
    """Shard ids assigned to ``replica`` under a width-``spr`` balanced
    diagonal assignment."""
    return tuple((replica * dj + k) % total for k in range(spr))


class CodewordStore:
    """Per-(group, value-id) RS shard maps with availability bitmaps.

    ``device`` must be the codec's device; it defaults to ``"cuda"`` like
    every entry point of the port."""

    def __init__(self, num_groups: int, code: RSCode, total: int,
                 dj: int = 1, device=None):
        dev = resolve_device(device)
        if dev != code.device:
            raise ValueError(f"codec lives on {code.device}, store on {dev}")
        self.code = code
        self.d = code.d
        self.T = total
        self.dj = dj
        self._lock = threading.Lock()
        # group -> vid -> {shard id: [L] int32}
        self._shards: list = [dict() for _ in range(num_groups)]
        self._dlen: list = [dict() for _ in range(num_groups)]
        self._spr: list = [dict() for _ in range(num_groups)]
        self._asg: list = [dict() for _ in range(num_groups)]

    # ------------------------------------------------------------- encode
    def encode(self, group: int, vid: int, batch: Any, spr: int
               ) -> Tuple[int, np.ndarray]:
        """Encode-once: serialize + RS-encode ``batch`` into the full
        ``[T, L]`` codeword, caching every shard; an already-held vid
        returns the cached rows."""
        with self._lock:
            held = self._shards[group].get(vid)
            if held is not None and len(held) == self.T:
                self._spr[group].setdefault(vid, spr)
                return (
                    self._dlen[group].get(vid, 0),
                    np.stack([held[i] for i in range(self.T)]),
                )
        dlen, cw = encode_payload(self.code, pickle.dumps(batch))
        with self._lock:
            self._dlen[group][vid] = dlen
            self._spr[group][vid] = spr
            self._shards[group].setdefault(vid, {}).update(
                {i: cw[i] for i in range(self.T)}
            )
        return dlen, cw

    # ------------------------------------------------------------- ingest
    def add_shards(self, group: int, vid: int, data_len: int,
                   shards: Dict[int, np.ndarray],
                   assigned: bool = False) -> None:
        """Ingest shard rows; ``assigned=True`` marks them as this
        replica's own assignment (eligible for durable vote logging)."""
        with self._lock:
            self._dlen[group].setdefault(vid, int(data_len))
            self._shards[group].setdefault(vid, {}).update(shards)
            if assigned:
                self._asg[group].setdefault(vid, set()).update(shards)

    # ------------------------------------------------------------ queries
    def have_mask(self, group: int, vid: int) -> int:
        """Availability bitmap over shard ids (bit s = shard s held)."""
        with self._lock:
            held = self._shards[group].get(vid)
            if not held:
                return 0
            m = 0
            for s in held:
                m |= 1 << s
            return m

    def can_reconstruct(self, group: int, vid: int) -> bool:
        with self._lock:
            return len(self._shards[group].get(vid) or ()) >= self.d

    def shards_for(self, group: int, vid: int,
                   exclude_mask: int = 0,
                   only_sids: Optional[Tuple[int, ...]] = None,
                   ) -> Optional[Tuple[int, Dict[int, np.ndarray]]]:
        """Held shards as ``(data_len, {sid: rows})`` minus the requester's
        ``exclude_mask``, optionally restricted to ``only_sids``."""
        with self._lock:
            held = self._shards[group].get(vid)
            if not held:
                return None
            sids = held.keys() if only_sids is None else [
                s for s in only_sids if s in held
            ]
            out = {
                s: held[s] for s in sids if not (exclude_mask >> s) & 1
            }
            if not out:
                return None
            return self._dlen[group].get(vid, 0), out

    def wal_shards(self, group: int, vid: int, me: int
                   ) -> Optional[Tuple[int, Dict[int, np.ndarray]]]:
        """The shard subset this replica durably logs for a voted vid: its
        own diagonal slice when it holds the full codeword, else the rows
        that arrived as its assignment (never foreign gossip rows)."""
        with self._lock:
            held = self._shards[group].get(vid)
            if not held:
                return None
            if len(held) == self.T:
                spr = self._spr[group].get(vid) or self.dj
                own = assigned_sids(me, max(spr, self.dj), self.dj, self.T)
                sub = {s: held[s] for s in own if s in held}
            else:
                asg = self._asg[group].get(vid) or ()
                sub = {s: held[s] for s in asg if s in held}
            if not sub:
                return None
            return self._dlen[group].get(vid, 0), sub

    # -------------------------------------------------------- reconstruct
    def reconstruct_batch(self, group: int, vid: int) -> Optional[Any]:
        """Decode the request batch once >= d shards are held (None
        otherwise), restoring every row of the codeword."""
        with self._lock:
            held = self._shards[group].get(vid)
            if held is None or len(held) < self.d:
                return None
            dlen = self._dlen[group].get(vid)
            if dlen is None:
                return None
            held = dict(held)
        rows = decode_rows(self.code, held)
        buf = unpack_bytes(rows, dlen)
        if len(held) < self.T:
            # restore every row at the encoder's lane count, so restored
            # shards are byte-identical to the originals
            if self.code.p:
                dev_rows = torch.from_numpy(
                    np.ascontiguousarray(rows, np.int32)
                ).to(self.code.device)
                parity = self.code.compute_parity(dev_rows[None])[0]
                parity = parity.cpu().numpy()
            else:
                parity = rows[:0]
            cw = np.concatenate([rows, parity], axis=0)
            with self._lock:
                self._shards[group].setdefault(vid, {}).update(
                    {i: cw[i] for i in range(self.T)}
                )
        return pickle.loads(buf)

    # ----------------------------------------------------------------- gc
    def gc_below(self, group: int, vid_floor: int) -> int:
        with self._lock:
            drop = [v for v in self._shards[group] if v < vid_floor]
            for v in drop:
                self._shards[group].pop(v, None)
                self._dlen[group].pop(v, None)
                self._spr[group].pop(v, None)
                self._asg[group].pop(v, None)
        return len(drop)

    def size(self, group: int) -> int:
        with self._lock:
            return len(self._shards[group])
