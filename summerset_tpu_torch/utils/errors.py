"""Framework-wide error type.

Parity: reference ``src/utils/error.rs:7-11`` (``SummersetError(String)`` with
conversions from all underlying error types).  In Python a single Exception
subclass with a message plays the same role.
"""

from __future__ import annotations

import logging


class SummersetError(Exception):
    """Single string-carrying error used across the framework."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.msg = msg

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.msg


def logged_err(logger: logging.Logger, msg: str) -> SummersetError:
    """Log an error message and return a ``SummersetError`` to raise.

    Parity: reference ``logged_err!`` macro (``src/utils/print.rs:16-40``).

    Usage::

        raise logged_err(log, f"unexpected message type: {m}")
    """
    logger.error(msg)
    return SummersetError(msg)
