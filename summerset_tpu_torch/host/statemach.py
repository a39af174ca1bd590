"""The replica's key-value state machine, counterpart of
``summerset_tpu/host/statemach.py``.

Parity: reference ``src/server/statemach.rs`` — ``Command::{Get, Put}`` ->
``CommandResult::{Get{value}, Put{old_value}}`` over a ``HashMap``
(statemach.rs:21-72), with the applier core a static function
(statemach.rs:191-193).  The port applies on the replica thread and has
no executor thread: ``snapshot_items`` is one dict copy, which runs
without releasing the interpreter lock.  Scans are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Command:
    """Get(key) / Put(key, value) (parity: ``Command``)."""

    kind: str  # "get" | "put"
    key: str
    value: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CommandResult:
    """Get -> value, Put -> old_value (parity: ``CommandResult``)."""

    kind: str
    value: Optional[str] = None
    old_value: Optional[str] = None


def apply_command(kv: Dict[str, str], cmd: Command) -> CommandResult:
    """Pure applier core (parity: the static ``execute`` fn)."""
    if cmd.kind == "get":
        return CommandResult("get", value=kv.get(cmd.key))
    if cmd.kind == "put":
        old = kv.get(cmd.key)
        kv[cmd.key] = cmd.value if cmd.value is not None else ""
        return CommandResult("put", old_value=old)
    raise ValueError(f"unknown command kind {cmd.kind}")


class StateMachine:
    """The KV map ``_kv``, applied to by the replica thread."""

    def __init__(self):
        self._kv: Dict[str, str] = {}

    def snapshot_items(self) -> Dict[str, str]:
        """A consistent copy of the map."""
        return dict(self._kv)
