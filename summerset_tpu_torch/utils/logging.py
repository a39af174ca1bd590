"""Node-identity-prefixed logging.

Parity: reference ``src/utils/print.rs`` — a process-global ``ME`` identity
string set once (e.g. ``"0"`` for replica 0, ``"m"`` for the manager), plus
``pf_trace!/pf_debug!/pf_info!/pf_warn!/pf_error!`` macros that prefix every
line with ``(id)``.  Cluster orchestration scripts *parse these lines* (e.g.
the "accepting clients" readiness probe), so the exact prefix format is part
of the de-facto API.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_ME: Optional[str] = None

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def set_me(identity: str) -> None:
    """Set the process-global node identity (once; later calls ignored).

    Parity: ``ME: OnceLock<String>`` (``src/utils/print.rs:8``).
    """
    global _ME
    if _ME is None:
        _ME = identity


def me() -> str:
    return _ME if _ME is not None else "?"


class _IdentityFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        record.me = me()
        return super().format(record)


def logger_init(level: Optional[str] = None) -> None:
    """Initialise root logging similar to ``logger_init`` (``print.rs:96``).

    Level comes from the ``SMR_LOG`` env var (parity with ``RUST_LOG``) unless
    given explicitly.  Format: ``[LEVEL (me) module] message``.
    """
    lvl_name = (level or os.environ.get("SMR_LOG", "info")).upper()
    lvl = TRACE if lvl_name == "TRACE" else getattr(logging, lvl_name, logging.INFO)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        _IdentityFormatter("[%(levelname)s (%(me)s) %(name)s] %(message)s")
    )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(lvl)


def pf_logger(name: str) -> logging.Logger:
    """Get a module logger; use with the ``pf_*`` convention."""
    return logging.getLogger(name)


def pf_trace(logger: logging.Logger, msg: str, *args) -> None:
    logger.log(TRACE, msg, *args)


def pf_debug(logger: logging.Logger, msg: str, *args) -> None:
    logger.debug(msg, *args)


def pf_info(logger: logging.Logger, msg: str, *args) -> None:
    logger.info(msg, *args)


def pf_warn(logger: logging.Logger, msg: str, *args) -> None:
    logger.warning(msg, *args)


def pf_error(logger: logging.Logger, msg: str, *args) -> None:
    logger.error(msg, *args)
