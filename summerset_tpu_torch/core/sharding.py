"""Device-mesh sharding for the batched engine, counterpart of
``summerset_tpu/core/sharding.py``.

A 2-D logical mesh with the axes of the JAX package:

- ``group``   -- independent consensus groups: ``[G, ...]`` state splits
                 here with no cross-shard traffic;
- ``replica`` -- the replicas of one group spread over shards: each shard
                 steps its own rows ``r0:r1`` of ``R`` (the kernel's row
                 window, ``ProtocolKernel.shard``) while every per-pair
                 and broadcast lane keeps all ``R`` peers as its last
                 replica axis.  The netmodel's transposed delivery of a
                 pair lane is then the all-to-all of the JAX mesh (each
                 receiver shard gathers its ``R_dst`` columns from every
                 sender shard of its group shard), and a broadcast lane,
                 the collective tally's records among them, is the
                 all-gather (:func:`exchange`).

There is no GSPMD here: a :class:`Mesh` is an array of ``torch.device``
handles, a sharded pytree is a :class:`Sharded` list of per-shard dicts
of plain tensors, and the engine steps the shards one after another on
their devices' current streams.  On distinct cards the launches of one
tick overlap across devices; shards on one card run in order.  Either
way a shard's result depends only on its inputs, so the digests do not
depend on the placement.

An explicit device list may repeat one device (``repeat=True``), for
example ``[torch.device("cuda:0")] * 4`` or eight CPU handles: the port's
counterpart of the JAX package's virtual CPU devices.  The default
device list is the visible CUDA devices, never the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

Pytree = Any
AXES = ("group", "replica")


def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse a ``"GxR"`` mesh spec (e.g. ``"4x2"``) into
    ``(group_shards, replica_shards)``: the grammar of the JAX package's
    ``utils/jaxcompat.parse_mesh``, which every ``--mesh`` flag and the
    server's ``device_mesh`` knob parse through."""
    parts = str(spec).lower().split("x")
    try:
        gs, rs = (int(p) for p in parts)
    except (TypeError, ValueError):
        raise ValueError(
            f"mesh spec {spec!r} is not of the form 'GxR' (e.g. '4x2': "
            "4 group shards x 2 replica shards)"
        ) from None
    if gs < 1 or rs < 1:
        raise ValueError(
            f"mesh spec {spec!r}: both axes must be >= 1"
        )
    return gs, rs


class Mesh:
    """A ``(group_shards, replica_shards)`` array of ``torch.device``
    handles with the axis names ``("group", "replica")``."""

    axis_names = AXES

    def __init__(self, devices: Sequence, group_shards: int,
                 replica_shards: int):
        devs = [_indexed(d) for d in devices]
        self.devices = np.empty((group_shards, replica_shards), dtype=object)
        for k, d in enumerate(devs):
            self.devices[k // replica_shards, k % replica_shards] = d

    @property
    def shape(self) -> Dict[str, int]:
        gs, rs = self.devices.shape
        return {"group": gs, "replica": rs}

    @property
    def spec(self) -> str:
        gs, rs = self.devices.shape
        return f"{gs}x{rs}"

    def cells(self) -> Iterator[Tuple[int, int, torch.device]]:
        """``(i, j, device)`` of every shard in row-major order (the
        order of :class:`Sharded`'s list)."""
        gs, rs = self.devices.shape
        for i in range(gs):
            for j in range(rs):
                yield i, j, self.devices[i, j]

    def __repr__(self) -> str:
        return f"Mesh({self.spec}, {[str(d) for d in self.devices.flat]})"


def _indexed(d) -> torch.device:
    """``d`` as a device with its index (``"cuda"`` is the current card):
    a shard's tensors report the indexed name."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> List[torch.device]:
    """The default device list: the visible CUDA devices (none without a
    card; the CPU is used only when a caller lists it)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def make_mesh(
    group_shards: Optional[int] = None,
    replica_shards: int = 1,
    devices: Optional[Sequence] = None,
    repeat: bool = False,
) -> Mesh:
    """Build a ``(group, replica)`` mesh over ``devices`` (default: the
    visible CUDA devices).  A device listed twice is refused unless
    ``repeat`` asks for it."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if group_shards is None:
        group_shards = n // replica_shards
    if group_shards * replica_shards != n:
        raise ValueError(
            f"mesh {group_shards}x{replica_shards} != {n} devices"
        )
    names = [str(_indexed(d)) for d in devices]
    if not repeat and len(set(names)) != len(names):
        raise ValueError(
            f"mesh {group_shards}x{replica_shards} lists a device more "
            f"than once ({names}); pass repeat=True to place several "
            "shards on one device"
        )
    return Mesh(devices, group_shards, replica_shards)


def mesh_for(
    group_shards: int,
    replica_shards: int,
    devices: Optional[Sequence] = None,
    repeat: bool = False,
) -> Mesh:
    """:func:`make_mesh` over the FIRST ``group_shards * replica_shards``
    devices, with a clear error when too few are visible."""
    devices = list(devices if devices is not None else visible_devices())
    need = group_shards * replica_shards
    if len(devices) < need:
        raise ValueError(
            f"mesh {group_shards}x{replica_shards} needs {need} devices "
            f"but only {len(devices)} are visible (to place several "
            "shards on one device, list it that many times and pass "
            "repeat=True)"
        )
    return make_mesh(group_shards, replica_shards, devices[:need],
                     repeat=repeat)


def check_mesh(mesh: Mesh, G: int, R: Optional[int]) -> None:
    """Refuse geometry the mesh cannot shard evenly, with an error that
    names the offending axis.  Uneven shards would need padded rows, and
    a padded phantom replica would vote.  ``R=None`` checks the group
    axis alone (a server learns its population later)."""
    gs = mesh.shape["group"]
    rs = mesh.shape["replica"]
    if G % gs != 0:
        raise ValueError(
            f"num_groups G={G} is not divisible by the mesh's "
            f"group_shards={gs}: each device must own an equal slice of "
            "the group axis (pick a mesh whose group axis divides G)"
        )
    if R is not None and R % rs != 0:
        raise ValueError(
            f"population R={R} is not divisible by the mesh's "
            f"replica_shards={rs}: replica rows cannot be split unevenly "
            "across devices (pick replica_shards dividing R, e.g. "
            f"{'1' if R % 2 else '1 or 2'})"
        )


# --------------------------------------------------------------- layouts --
def _leaf_spec(leaf) -> Tuple:
    if leaf.ndim == 0:
        return ()
    axes: list = ["group"]
    if leaf.ndim >= 2:
        axes.append("replica")
    return tuple(axes + [None] * (leaf.ndim - len(axes)))


def state_sharding(mesh: Mesh, state: Pytree) -> Pytree:
    """Per-leaf layout of a state/outbox pytree, one axis name (or None)
    per dim: every leaf leads with ``[G, R(, ...)]``, ``G`` splits over
    ``group`` and the first ``R`` over ``replica``; trailing dims stay
    whole."""
    return {k: _leaf_spec(v) for k, v in state.items()}


def netstate_sharding(mesh: Mesh, netstate: Pytree) -> Pytree:
    """Per-leaf layout of a NetModel netstate: ``bufs`` leaves lead with
    the delay axis ``[D, G, R_src, ...]`` (D whole; the lane-packed
    buffers ``[D, L, G, R_src, ...]`` keep L whole too), ``rng`` is
    ``[G, R, R]``, ``last_due`` ``[G, R]``, scalars whole."""

    def buf_spec(key, leaf):
        lead = [None, None] if key in ("__pair__", "__bcast__") else [None]
        return tuple(lead + ["group", "replica"]
                     + [None] * (leaf.ndim - len(lead) - 2))

    return {
        "bufs": {k: buf_spec(k, v) for k, v in netstate["bufs"].items()},
        "cursor": (),
        "tick": (),
        "last_due": ("group", "replica"),
        "rng": ("group", "replica", None),
    }


def mesh_stamp(group_shards: int, replica_shards: int, G: int) -> dict:
    """The canonical mesh block every artifact stamps (the bench's mesh
    runs, PROFILE.json's mesh-sweep points): one schema, the JAX
    package's."""
    return {
        "mesh": f"{group_shards}x{replica_shards}",
        "group_shards": group_shards,
        "replica_shards": replica_shards,
        "devices": group_shards * replica_shards,
        "groups_per_device": G // group_shards,
    }


def _cell_index(spec: Tuple, shape, mesh: Mesh, i: int, j: int):
    gs, rs = mesh.shape["group"], mesh.shape["replica"]
    idx = []
    for ax, n in zip(spec, shape):
        if ax == "group":
            w = n // gs
            idx.append(slice(i * w, (i + 1) * w))
        elif ax == "replica":
            w = n // rs
            idx.append(slice(j * w, (j + 1) * w))
        else:
            idx.append(slice(None))
    return tuple(idx)


def _place_copy(leaf: torch.Tensor, device) -> torch.Tensor:
    """A FRESH contiguous copy of ``leaf`` on ``device``, never a view of
    it, even where the slice already lies there contiguously: the
    engine's boot template (which a device reset rewinds rows to and a
    later ``init()`` hands out again) must never share memory with a
    shard the caller holds.  Init-time only, never on the tick path."""
    out = torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device=device)
    out.copy_(leaf)
    return out


def _map_spec(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


class Sharded:
    """A pytree placed on a mesh: ``shards[c]`` is the dict of cell
    ``c`` (row-major over ``mesh.cells()``), ``specs`` the layout it was
    split by.  Reading a key gathers the whole leaf (:func:`gather_leaf`,
    on the first shard's device): the host's reads and digests; the tick
    path only ever touches ``shards``."""

    def __init__(self, mesh: Mesh, shards: List[Dict[str, Any]],
                 specs: Dict[str, Any]):
        self.mesh = mesh
        self.shards = shards
        self.specs = specs

    def __contains__(self, key) -> bool:
        return key in self.specs

    def __iter__(self):
        return iter(self.specs)

    def keys(self):
        return self.specs.keys()

    def __getitem__(self, key):
        return _gather_tree(self.mesh, [s[key] for s in self.shards],
                            self.specs[key])

    def items(self):
        return ((k, self[k]) for k in self.specs)

    def row(self, key, r: int) -> torch.Tensor:
        """``self[key][:, r]`` read from the shards that hold row ``r``
        only (one per group shard)."""
        rs = self.mesh.shape["replica"]
        parts = [s[key] for s in self.shards]
        Rs = parts[0].shape[1]
        j, rr = divmod(r, Rs)
        cols = [parts[i * rs + j][:, rr] for i in range(self.mesh.shape[
            "group"])]
        dev = parts[0].device
        return torch.cat([c.to(dev) for c in cols], dim=0)

    def gather(self, device=None) -> Dict[str, Any]:
        """The whole pytree (on ``device``, default the first shard's)."""
        return {k: _gather_tree(self.mesh, [s[k] for s in self.shards],
                                self.specs[k], device)
                for k in self.specs}

    def devices(self) -> List[set]:
        """Per shard, the set of devices its leaves sit on."""
        return [{str(t.device) for t in _leaves(s)} for s in self.shards]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _gather_tree(mesh: Mesh, parts: list, spec, device=None):
    if isinstance(spec, dict):
        return {k: _gather_tree(mesh, [p[k] for p in parts], spec[k], device)
                for k in spec}
    return gather_leaf(mesh, parts, spec, device)


def gather_leaf(mesh: Mesh, parts: List[torch.Tensor], spec: Tuple,
                device=None) -> torch.Tensor:
    """The whole tensor from its per-shard parts (row-major cells)."""
    gs, rs = mesh.shape["group"], mesh.shape["replica"]
    dev = parts[0].device if device is None else torch.device(device)
    if "group" not in spec:
        return parts[0].to(dev)
    gax = spec.index("group")
    rows = []
    for i in range(gs):
        cell = [p.to(dev) for p in parts[i * rs:(i + 1) * rs]]
        if "replica" in spec and rs > 1:
            rows.append(torch.cat(cell, dim=spec.index("replica")))
        else:
            rows.append(cell[0])
    return rows[0] if gs == 1 else torch.cat(rows, dim=gax)


def _split(mesh: Mesh, tree: Pytree, specs: Pytree) -> Sharded:
    shards = []
    for i, j, dev in mesh.cells():
        shards.append(_map_spec(
            lambda leaf, sp, i=i, j=j, dev=dev: _place_copy(
                leaf[_cell_index(sp, leaf.shape, mesh, i, j)], dev),
            tree, specs))
    return Sharded(mesh, shards, specs)


def shard_pytree(mesh: Mesh, tree: Pytree) -> Sharded:
    """Place a state pytree onto the mesh with the group/replica layout.
    Every shard holds FRESH tensors (:func:`_place_copy`)."""
    if isinstance(tree, Sharded):
        tree = tree.gather()
    return _split(mesh, tree, state_sharding(mesh, tree))


def shard_netstate(mesh: Mesh, netstate: Pytree) -> Sharded:
    """Place a netstate onto the mesh (delay axis whole; fresh tensors
    as :func:`shard_pytree`)."""
    if isinstance(netstate, Sharded):
        netstate = netstate.gather()
    return _split(mesh, netstate, netstate_sharding(mesh, netstate))


def gather_pytree(tree, device=None) -> Dict[str, Any]:
    """The whole state pytree of a :class:`Sharded` (a plain dict is
    returned as it is): host reads and digests."""
    return tree.gather(device) if isinstance(tree, Sharded) else tree


gather_netstate = gather_pytree


def slice_inputs(mesh: Mesh, inputs: Dict[str, Any], i: int, j: int,
                 codes: Dict[str, str]) -> Dict[str, Any]:
    """Cell ``(i, j)``'s part of a tick's inputs, on its device.  A leaf
    splits by its shape code (``g`` = ``[G]``, ``gr`` = ``[G, R]``,
    ``grr`` = ``[G, R, R]``, ``gp`` = ``[G, P]``; unknown keys by rank as
    a state leaf)."""
    dev = mesh.devices[i, j]
    out = {}
    for k, v in inputs.items():
        if not torch.is_tensor(v) or v.ndim == 0:
            out[k] = v.to(dev) if torch.is_tensor(v) else v
            continue
        if codes.get(k) in ("g", "gp") or v.ndim == 1:
            spec = ("group",) + (None,) * (v.ndim - 1)
        else:
            spec = _leaf_spec(v)
        out[k] = v[_cell_index(spec, v.shape, mesh, i, j)].to(dev)
    return out


INPUT_CODES = {
    "n_proposals": "g", "value_base": "g", "exec_floor": "gr",
    "alive": "gr", "link_up": "grr", "reset": "gr",
}


# ------------------------------------------------------ sharded delivery --
def _lane_axes(key: str, broadcast) -> Tuple[int, Optional[int]]:
    """(source axis, destination axis or None) of a dequeued lane: packed
    pair ``[L, G, R_src, R_dst, ...]``, packed broadcast ``[L, G, R_src,
    ...]``, loose pair ``[G, R_src, R_dst, ...]``, loose broadcast ``[G,
    R_src, ...]``."""
    if key == "__pair__":
        return 2, 3
    if key == "__bcast__":
        return 2, None
    if key in broadcast:
        return 1, None
    return 1, 2


def exchange(mesh: Mesh, raws: List[Dict[str, torch.Tensor]],
             broadcast, scope, counter: Dict[str, int]
             ) -> List[Dict[str, torch.Tensor]]:
    """The mesh's message delivery between dequeue and receive: each
    receiver shard ``(i, j)`` gathers, from every sender shard ``(i,
    j')`` of its group shard, its own ``R_dst`` columns of every pair
    lane (the all-to-all) and the whole of every broadcast lane (the
    all-gather), concatenated along the source axis, each lane under
    ``scope(lane)``.  With one replica shard nothing moves.  The bytes
    that cross between shards accumulate in ``counter["bytes"]``."""
    rs = mesh.shape["replica"]
    if rs == 1:
        return raws
    out = []
    for i, j, dev in mesh.cells():
        group = raws[i * rs:(i + 1) * rs]
        recv = {}
        for k in group[j]:
            src_ax, dst_ax = _lane_axes(k, broadcast)
            with scope(k):
                pieces = []
                for jj, part in enumerate(group):
                    v = part[k]
                    if dst_ax is not None:
                        w = v.shape[dst_ax] // rs
                        v = v.narrow(dst_ax, j * w, w)
                    if jj != j:
                        counter["bytes"] += v.numel() * v.element_size()
                    pieces.append(v.to(dev))
                recv[k] = torch.cat(pieces, dim=src_ax)
        out.append(recv)
    return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) pytree or :class:`Sharded`."""
    trees = tree.shards if isinstance(tree, Sharded) else [tree]
    return sum(t.numel() * t.element_size()
               for x in trees for t in _leaves(x))


# ------------------------------------------------------- the serving step --
def mesh_devices(spec) -> Optional[List[torch.device]]:
    """An explicit mesh device list from a server config value: a list of
    device names or one comma-separated string (``"cuda:0,cuda:0"``);
    ``None`` or empty leaves the default (the visible CUDA devices)."""
    if spec is None or spec == "" or spec == []:
        return None
    names = spec.split(",") if isinstance(spec, str) else list(spec)
    return [torch.device(str(n).strip()) for n in names]


def mesh_step(kernel, mesh: Mesh):
    """The serving step on a mesh, counterpart of the JAX server's
    ``_shared_step(kernel, mesh_shape)``: ``step(state, inbox, inputs)``
    takes the state as :class:`Sharded` and the host's whole inbox and
    inputs, steps every shard's kernel on its slice (pair lanes by group
    and receiving row, broadcast lanes by group with every sender) and
    returns the new :class:`Sharded` state with the outbox and effects
    whole, as the unsharded step returns them."""
    from .protocol import StepEffects

    check_mesh(mesh, kernel.G, kernel.R)
    gs, rs = mesh.shape["group"], mesh.shape["replica"]
    Gs, Rs = kernel.G // gs, kernel.R // rs
    cells = [kernel.shard(Gs, j * Rs, Rs, dev) for i, j, dev in mesh.cells()]
    codes = dict(INPUT_CODES, **dict(kernel.EXTRA_INPUTS or ()))
    bcast = kernel.broadcast_lanes

    def inbox_part(inbox, i, j, dev):
        out = {}
        for k, v in inbox.items():
            spec = _leaf_spec(v)
            if k in bcast:
                spec = tuple(None if a == "replica" else a for a in spec)
            out[k] = v[_cell_index(spec, v.shape, mesh, i, j)].to(dev)
        return out

    def whole(parts):
        return gather_leaf(mesh, parts, _leaf_spec(parts[0]))

    def step(state: Sharded, inbox, inputs):
        news, outs, fxs = [], [], []
        for c, (i, j, dev) in enumerate(mesh.cells()):
            new, out, fx = cells[c].step(
                state.shards[c], inbox_part(inbox, i, j, dev),
                slice_inputs(mesh, inputs, i, j, codes))
            news.append(new)
            outs.append(out)
            fxs.append(fx)
        fx = StepEffects(
            commit_bar=whole([f.commit_bar for f in fxs]),
            exec_bar=whole([f.exec_bar for f in fxs]),
            extra={k: whole([f.extra[k] for f in fxs]) for k in fxs[0].extra},
        )
        return (Sharded(mesh, news, state.specs),
                {k: whole([o[k] for o in outs]) for k in outs[0]}, fx)

    return step
