"""The replica's key-value state machine, counterpart of
``summerset_tpu/host/statemach.py``.

Parity: reference ``src/server/statemach.rs`` — ``Command::{Get, Put}`` ->
``CommandResult::{Get{value}, Put{old_value}}`` over a ``HashMap``
(statemach.rs:21-72), with the applier core a static function
(statemach.rs:191-193).  The port applies on the replica thread and has
no executor thread: ``snapshot_items`` is one dict copy, which runs
without releasing the interpreter lock.  ``scan`` is the JAX package's
ordered range read (``scan_items``), shared by the applier and the
server's scan serving.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Command:
    """Get(key) / Put(key, value) / Scan(key, end, limit) (parity:
    ``Command``; scan is the ordered range read over the half-open
    ``[key, end)``, ``end=None`` unbounded, ``limit=0`` unlimited).  The
    scan fields default, so the wire codec's fast paths, which fill only
    the get/put triple, resolve them through the class attributes.
    Fields in the JAX declaration order (the codec's struct id 3)."""

    kind: str  # "get" | "put" | "scan"
    key: str
    value: Optional[str] = None
    end: Optional[str] = None   # scan: exclusive upper bound
    limit: int = 0              # scan: max keys returned (0 = no cap)


@dataclasses.dataclass(frozen=True)
class CommandResult:
    """Get -> value, Put -> old_value, Scan -> items (sorted
    ``(key, value)`` pairs) (parity: ``CommandResult``)."""

    kind: str
    value: Optional[str] = None
    old_value: Optional[str] = None
    items: Optional[tuple] = None  # scan: ((key, value), ...) sorted


def apply_command(kv: Dict[str, str], cmd: Command) -> CommandResult:
    """Pure applier core (parity: the static ``execute`` fn)."""
    if cmd.kind == "get":
        return CommandResult("get", value=kv.get(cmd.key))
    if cmd.kind == "put":
        old = kv.get(cmd.key)
        kv[cmd.key] = cmd.value if cmd.value is not None else ""
        return CommandResult("put", old_value=old)
    if cmd.kind == "scan":
        return CommandResult("scan", items=scan_items(
            kv, cmd.key, cmd.end, cmd.limit,
        ))
    raise ValueError(f"unknown command kind {cmd.kind}")


def scan_items(kv: Dict[str, str], start: str, end: Optional[str],
               limit: int) -> tuple:
    """Ordered range read over a KV dict: sorted ``(key, value)`` pairs
    with ``start <= key`` (``< end`` when bounded), cut to ``limit`` when
    positive."""
    keys = sorted(
        k for k in kv
        if k >= start and (end is None or k < end)
    )
    if limit and limit > 0:
        keys = keys[:limit]
    return tuple((k, kv[k]) for k in keys)


class StateMachine:
    """The KV map ``_kv``, applied to by the replica thread."""

    def __init__(self):
        self._kv: Dict[str, str] = {}

    def snapshot_items(self) -> Dict[str, str]:
        """A consistent copy of the map."""
        return dict(self._kv)
