"""TOML-string config overrides over dataclass defaults, counterpart of
``summerset_tpu/utils/config.py``.

Parity: reference ``parsed_config!`` macro (``src/utils/config.rs:12-47``):
each protocol has a ``ReplicaConfigXxx`` / ``ClientConfigXxx`` struct with
``Default``; the CLI passes ``--config "a=1+b='x'"`` where ``+`` means
newline; the macro TOML-parses the string, overrides only the listed fields,
and *rejects unknown fields*.

Here every config is a ``@dataclass`` with defaults and ``parsed_config``
applies the same semantics via ``tomllib``.
"""

from __future__ import annotations

import dataclasses
try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is API-compatible
    import tomli as tomllib
from typing import Type, TypeVar

from .errors import SummersetError

T = TypeVar("T")

config_field = dataclasses.field  # re-export for config dataclass authors


def _plus_to_newlines(s: str) -> str:
    """Replace ``+`` with newlines, except inside quoted TOML strings."""
    out = []
    quote = None
    for ch in s:
        if quote is None and ch in ("'", '"'):
            quote = ch
        elif ch == quote:
            quote = None
        if ch == "+" and quote is None:
            out.append("\n")
        else:
            out.append(ch)
    return "".join(out)


def parsed_config(cls: Type[T], config_str: str | None) -> T:
    """Build ``cls()`` from defaults, overridden by a TOML config string.

    ``config_str`` uses ``+`` as a line separator (parity with the server CLI
    ``--config`` flag, reference ``summerset_server/src/main.rs:112``).
    Unknown fields raise ``SummersetError`` (parity with the macro's
    unknown-field rejection).
    """
    if not dataclasses.is_dataclass(cls):
        raise SummersetError(f"config class {cls!r} is not a dataclass")
    inst = cls()
    if not config_str:
        return inst
    toml_src = _plus_to_newlines(config_str)
    try:
        overrides = tomllib.loads(toml_src)
    except tomllib.TOMLDecodeError as e:
        raise SummersetError(f"invalid config string {config_str!r}: {e}") from e
    valid = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in overrides.items():
        if key not in valid:
            raise SummersetError(
                f"unknown config field '{key}' for {cls.__name__}"
            )
        cur = getattr(inst, key)
        # Accept int where float expected (TOML "1" parses as int).
        if isinstance(cur, float) and isinstance(val, int) and not isinstance(val, bool):
            val = float(val)
        # bool is a subclass of int in Python; treat them as distinct here.
        if cur is not None and (
            not isinstance(val, type(cur)) or isinstance(cur, bool) != isinstance(val, bool)
        ):
            raise SummersetError(
                f"config field '{key}' expects {type(cur).__name__}, "
                f"got {type(val).__name__}"
            )
        setattr(inst, key, val)
    return inst


def config_to_str(cfg) -> str:
    """Render a config dataclass back to the ``+``-separated string form."""
    parts = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, bool):
            parts.append(f"{f.name}={'true' if v else 'false'}")
        elif isinstance(v, str):
            parts.append(f"{f.name}='{v}'")
        elif v is not None and not isinstance(v, (list, dict)):
            parts.append(f"{f.name}={v}")
    return "+".join(parts)
