"""Lockstep network model, counterpart of ``summerset_tpu/core/netmodel.py``.

Message delivery is a tensor transform: a delay line of ``D`` buffers per
outbox lane, with loss, partitions and paused replicas as masks on the
``flags`` lane.  Per-pair fields are sent ``[G, R_src, R_dst]`` and
delivered transposed ``[G, R_dst, R_src]``; broadcast lanes are delivered
as sent.  With the default ``D == 1`` the lanes of one shape travel
stacked (one buffer write and one transpose per tick).

Netstate scalars (``cursor``, ``tick``) are 0-dim tensors on the device,
and every slot of the delay line is selected with a one-hot mask or
``index_select``, so a tick never waits for the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..ops import prng
from .quorum import tally_scope

@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Static network emulation parameters (ticks / probabilities)."""

    delay_ticks: int = 1
    max_delay_ticks: int = 1
    jitter_ticks: int = 0
    drop_rate: float = 0.0
    # stack same-shape int32 lanes through the delay line; None resolves
    # to on for the uniform 1-tick line, off otherwise
    pack_lanes: Optional[bool] = None

    def __post_init__(self):
        if self.delay_ticks < 1:
            raise ValueError("delay_ticks must be >= 1")
        if self.max_delay_ticks < self.delay_ticks + self.jitter_ticks:
            object.__setattr__(
                self, "max_delay_ticks", self.delay_ticks + self.jitter_ticks
            )
        if self.pack_lanes and self.max_delay_ticks != 1:
            raise ValueError("pack_lanes requires max_delay_ticks == 1")

    @property
    def lanes_packed(self) -> bool:
        """The resolved packing decision (what NetModel consults)."""
        if self.pack_lanes is None:
            return self.max_delay_ticks == 1
        return bool(self.pack_lanes)


def _bool(a, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, bool), device=device)


@dataclasses.dataclass
class ControlInputs:
    """Per-tick fault-injection masks.

    ``alive``:   [G, R] bool — False freezes a replica (pause).
    ``link_up``: [G, R, R] bool — False drops messages src->dst.
    ``reset``:   [G, R] bool — True rebuilds the row from its durable
                 leaves at the start of the tick (device crash-restart).

    The constructors return CPU tensors unless given ``device``.
    """

    alive: Any = None
    link_up: Any = None
    reset: Any = None

    @staticmethod
    def all_up(G: int, R: int, device="cpu") -> "ControlInputs":
        return ControlInputs(
            alive=torch.ones((G, R), dtype=torch.bool, device=device),
            link_up=torch.ones((G, R, R), dtype=torch.bool, device=device),
        )

    @staticmethod
    def links_all_up(G: int, R: int, device="cpu"):
        return torch.ones((G, R, R), dtype=torch.bool, device=device)

    @staticmethod
    def split_links(G: int, R: int, side, device="cpu"):
        """Symmetric partition between ``side`` and its complement."""
        a = np.zeros(R, bool)
        a[list(side)] = True
        link = np.ones((G, R, R), bool)
        link &= ~(a[:, None] ^ a[None, :])[None, :, :]
        return _bool(link, device)

    @staticmethod
    def isolate_links(G: int, R: int, *victims, device="cpu"):
        """Each victim alone (self-link kept), both directions."""
        v = np.zeros(R, bool)
        v[list(victims)] = True
        link = np.ones((G, R, R), bool)
        link &= ~(v[:, None] | v[None, :])[None, :, :]
        link |= np.eye(R, dtype=bool)[None, :, :]
        return _bool(link, device)

    @staticmethod
    def one_way_down(G: int, R: int, src: int, dst: int, device="cpu"):
        """Messages ``src -> dst`` dropped; the reverse still delivers."""
        link = np.ones((G, R, R), bool)
        link[:, src, dst] = False
        return _bool(link, device)

    @staticmethod
    def skew_alive(G: int, R: int, ticks: int, rates: dict,
                   offset: int = 0, device="cpu"):
        """Per-replica clock skew as duty-cycled ``[T, G, R]`` alive masks."""
        alive = np.ones((ticks, G, R), bool)
        t = np.arange(offset, offset + ticks, dtype=np.float64)
        for r, rate in rates.items():
            if not 0.0 < rate <= 1.0:
                raise ValueError(f"skew rate must be in (0, 1]: {rate}")
            on = np.floor((t + 1) * rate) > np.floor(t * rate)
            alive[:, :, int(r)] &= on[:, None]
        return _bool(alive, device)


class NetModel:
    """Delay-line message delivery with loss/partition masking.

    Netstate: ``bufs`` (per-lane ``[D, ...]`` tensors, slot
    ``(cursor + d) % D`` due in ``d`` ticks), ``cursor``, ``last_due``,
    ``tick`` and the ``[G, R, R]`` PRNG lane ``rng``."""

    def __init__(self, cfg: NetConfig, num_groups: int, population: int,
                 broadcast_lanes: frozenset,
                 tally_lanes: frozenset = frozenset(), device="cpu"):
        self.cfg = cfg
        self.G = num_groups
        self.R = population
        self.broadcast_lanes = broadcast_lanes
        self.tally_lanes = tally_lanes
        self.device = torch.device(device)
        self._pack_pair: tuple = ()
        self._pack_bcast: tuple = ()

    def _lane_scope(self, key: str):
        if key in self.tally_lanes:
            return tally_scope()
        return contextlib.nullcontext()

    def _plan_packing(self, zero_outbox) -> None:
        """Group same-shape int32 lanes for stacked transport: per-pair
        [G, R, R] lanes and [G, R_src, W] window lanes; ``flags``, odd
        shapes and the tally lanes stay loose."""
        pair, bcast = [], []
        bshape = None
        for k, v in zero_outbox.items():
            if (
                k == "flags"
                or v.dtype != torch.int32
                or k in self.tally_lanes
            ):
                continue
            if k in self.broadcast_lanes:
                if v.ndim != 3:
                    continue
                if bshape is None:
                    bshape = tuple(v.shape)
                if tuple(v.shape) == bshape:
                    bcast.append(k)
            elif tuple(v.shape) == (self.G, self.R, self.R):
                pair.append(k)
        self._pack_pair = tuple(sorted(pair))
        self._pack_bcast = tuple(sorted(bcast))

    def _pack(self, outbox):
        packed = {
            k: v for k, v in outbox.items()
            if k not in self._pack_pair and k not in self._pack_bcast
        }
        if self._pack_pair:
            packed["__pair__"] = torch.stack(
                [outbox[k] for k in self._pack_pair]
            )
        if self._pack_bcast:
            packed["__bcast__"] = torch.stack(
                [outbox[k] for k in self._pack_bcast]
            )
        return packed

    def _unpack(self, packed):
        out = {
            k: v for k, v in packed.items()
            if k not in ("__pair__", "__bcast__")
        }
        if "__pair__" in packed:
            for i, k in enumerate(self._pack_pair):
                out[k] = packed["__pair__"][i]
        if "__bcast__" in packed:
            for i, k in enumerate(self._pack_bcast):
                out[k] = packed["__bcast__"][i]
        return out

    def init_netstate(self, zero_outbox, seed: int = 17):
        D = self.cfg.max_delay_ticks
        if self.cfg.lanes_packed:
            self._plan_packing(zero_outbox)
            zero_outbox = self._pack(dict(zero_outbox))
        dev = self.device
        bufs = {
            k: torch.zeros((D,) + tuple(x.shape), dtype=x.dtype, device=dev)
            for k, x in zero_outbox.items()
        }
        return {
            "bufs": bufs,
            "cursor": torch.zeros((), dtype=torch.int32, device=dev),
            "last_due": torch.zeros((self.G, self.R), dtype=torch.int32,
                                    device=dev),
            "tick": torch.zeros((), dtype=torch.int32, device=dev),
            "rng": prng.seed_state(17 + seed, (self.G, self.R, self.R),
                                   device=dev),
        }

    def pop(self, netstate, ctrl: Optional[ControlInputs] = None
            ) -> Tuple[Any, Any]:
        """Dequeue the messages due this tick, oriented for receivers."""
        D = self.cfg.max_delay_ticks
        cursor = netstate["cursor"]
        bufs = netstate["bufs"]
        raw = {}
        if D == 1:
            for k, b in bufs.items():
                with self._lane_scope(k):
                    raw[k] = b[0]
        else:
            at_cursor = (
                torch.arange(D, dtype=torch.int32, device=cursor.device)
                == cursor
            )
            idx = cursor.reshape(1).to(torch.int64)
            nbufs = {}
            for k, b in bufs.items():
                with self._lane_scope(k):
                    raw[k] = torch.index_select(b, 0, idx)[0]
                    oh = at_cursor.reshape((D,) + (1,) * (b.ndim - 1))
                    nbufs[k] = torch.where(oh, 0, b)
            bufs = nbufs

        # receiver-side mask: a replica paused now receives nothing
        flags = raw["flags"]
        if ctrl is not None and ctrl.alive is not None:
            flags = torch.where(ctrl.alive[:, None, :], flags, 0)
        raw = dict(raw, flags=flags)

        inbox = {}
        if self.cfg.lanes_packed:
            for k, v in raw.items():
                with self._lane_scope(k):
                    if k == "__pair__":
                        v = v.transpose(2, 3)
                    elif k != "__bcast__" and k not in self.broadcast_lanes:
                        v = v.transpose(1, 2)
                    inbox[k] = v
            inbox = self._unpack(inbox)
        else:
            for k, v in raw.items():
                with self._lane_scope(k):
                    inbox[k] = (
                        v if k in self.broadcast_lanes else v.transpose(1, 2)
                    )
        return dict(netstate, bufs=bufs), inbox

    def push(self, netstate, outbox, ctrl: Optional[ControlInputs] = None,
             telem: Optional[torch.Tensor] = None):
        """Enqueue this tick's outbox with sender-side masking; advance the
        tick.  With ``telem`` the drop/delay lanes are accounted here and
        ``(netstate, telem)`` is returned."""
        from . import telemetry as _tm

        cfg = self.cfg
        D = cfg.max_delay_ticks
        bufs = netstate["bufs"]
        cursor = netstate["cursor"]
        rng = netstate["rng"]

        flags = outbox["flags"]
        mask = torch.ones(flags.shape, dtype=torch.bool, device=flags.device)
        alive_src = None
        masked_any = cfg.drop_rate > 0.0
        if ctrl is not None and ctrl.alive is not None:
            alive_src = ctrl.alive[:, :, None]
            mask = mask & alive_src
            masked_any = True
        if ctrl is not None and ctrl.link_up is not None:
            mask = mask & ctrl.link_up
            masked_any = True
        if cfg.drop_rate > 0.0:
            rng, u = prng.uniform_unit(rng)
            # the JAX reference compares float32 draws with the rate
            # rounded to float32
            mask = mask & (u >= float(np.float32(cfg.drop_rate)))
        if telem is not None and masked_any:
            lost = (flags != 0) & ~mask
            if alive_src is not None:
                lost = lost & alive_src
            telem = _tm.bump(
                telem, "net_drops", lost.sum(dim=2, dtype=torch.int32)
            )
        outbox = dict(outbox, flags=torch.where(mask, flags, 0))
        if cfg.lanes_packed:
            outbox = self._pack(outbox)

        tick = netstate["tick"]
        last_due = netstate["last_due"]
        if D == 1:
            nbufs = {}
            for k in bufs:
                with self._lane_scope(k):
                    nbufs[k] = outbox[k].unsqueeze(0)
            bufs = nbufs
        else:
            # jitter per (group, source), not per link, so a source's
            # broadcast lanes land in the same slot as its pair records
            delay = torch.full((self.G, self.R), cfg.delay_ticks,
                               dtype=torch.int32, device=rng.device)
            if cfg.jitter_ticks > 0:
                rng_nxt, extra = prng.uniform_int(
                    rng[:, :, 0], 0, cfg.jitter_ticks + 1
                )
                rng = torch.cat([rng_nxt.unsqueeze(-1), rng[:, :, 1:]],
                                dim=-1)
                delay = delay + extra
                if telem is not None:
                    nsent = (outbox["flags"] != 0).sum(
                        dim=2, dtype=torch.int32
                    )
                    telem = _tm.bump(telem, "net_delay_ticks", extra * nsent)
            # due tick strictly after the source's previous one (FIFO, no
            # clobbering) and within the ring
            due_abs = torch.minimum(
                torch.maximum(
                    torch.maximum(tick + delay, last_due + 1), tick + 1
                ),
                tick + D,
            )
            last_due = due_abs
            due = torch.remainder(cursor + (due_abs - tick), D)
            arange_d = torch.arange(D, dtype=torch.int32, device=due.device)
            oh_src = arange_d[:, None, None] == due[None]  # [D, G, R_src]

            nbufs = {}
            for k in outbox:
                with self._lane_scope(k):
                    field = outbox[k]
                    oh = oh_src.reshape(
                        oh_src.shape + (1,) * (field.ndim - 2)
                    )
                    nbufs[k] = torch.where(oh, field[None], bufs[k])
            bufs = nbufs

        out = {
            "bufs": bufs,
            "cursor": torch.remainder(cursor + 1, max(D, 1)),
            "last_due": last_due,
            "tick": tick + 1,
            "rng": rng,
        }
        return out if telem is None else (out, telem)
