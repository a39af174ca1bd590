"""StorageHub: durable WAL logger behind a submit/result queue, counterpart
of ``summerset_tpu/host/storage.py``.

Parity: reference ``src/server/storage.rs`` — a hub owning a logger
thread; actions ``Read/Append/Truncate`` (and a bare fsync) over 8-byte
length-prefixed entries in a flat file, with optional fsync
(``LogAction`` storage.rs:25-45, ``LogResult`` :49-70).  Entries are
pickled Python objects.  The file backend is the native C++ WAL
(``csrc/wal.cpp``, the port's copy of ``summerset_tpu/native/wal.cpp``)
built at first use with ``g++`` into ``_build/`` and bound with ctypes
(``_NativeWal``); the pure-Python ``_PyWal`` writes the same format and
is the mirror for ``prefer_native=False`` and for a host where the build
fails.  As in the JAX package a failed build falls back to ``_PyWal``;
unlike it, every hub logs which backend opened its file, and
``StorageHub.native`` says which one did.

WAL record shapes (written by ``host/server.py``, replayed at recovery):

- ``("vote", g, rec)`` — durable acceptor row for group ``g``: one int
  per ``DURABLE_SCALARS`` field, one list per ``DURABLE_WINDOWS`` lane,
  plus ``rec["pp"]``, vid -> full ReqBatch for newly voted value ids.
- ``(g, slot, vid, batch)`` — exec-time apply record (KV replay source).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import pickle
import queue
import struct
import threading
import time
from typing import Any, Optional, Tuple

from ..utils.errors import SummersetError
from ..utils.logging import pf_info, pf_logger, pf_warn

logger = pf_logger("storage")

_LEN = struct.Struct("<Q")

# background-channel action ids (the pipelined group-commit plane): a
# fire-and-forget append delivers NO result; a flush carries its token
_BG_APPEND = "__bg_append__"
_BG_FLUSH = "__bg_flush__"


@dataclasses.dataclass
class LogAction:
    """One logger action (parity: ``LogAction``, storage.rs:25-45)."""

    kind: str        # read | append | truncate | sync
    entry: Any = None         # append payload (any picklable object)
    offset: int = 0           # read/truncate target offset
    sync: bool = False        # fsync after mutating


@dataclasses.dataclass
class LogResult:
    """Logger completion (parity: ``LogResult``, storage.rs:49-70)."""

    kind: str
    entry: Any = None           # read: the decoded entry (None past end)
    end_offset: int = 0         # read/append: entry end offset
    offset_ok: bool = True      # read/truncate validity
    now_size: int = 0           # truncate/sync: resulting log size


class _PyWal:
    """Flat-file WAL backend (the format of ``native/wal.cpp``)."""

    def __init__(self, path: str):
        # r+b (not a+b): O_APPEND would ignore seeks on write
        if not os.path.exists(path):
            open(path, "wb").close()
        self.f = open(path, "r+b")
        self.f.seek(0, os.SEEK_END)
        self.size = self.f.tell()

    def append(self, body: bytes, sync: bool) -> int:
        self.f.seek(self.size)
        self.f.write(_LEN.pack(len(body)) + body)
        self.size += 8 + len(body)
        self.f.flush()
        if sync:
            os.fdatasync(self.f.fileno())
        return self.size

    def read(self, off: int) -> Optional[Tuple[bytes, int]]:
        if off + 8 > self.size:
            return None
        self.f.seek(off)
        (length,) = _LEN.unpack(self.f.read(8))
        if off + 8 + length > self.size:
            return None
        return self.f.read(length), off + 8 + length

    def truncate(self, off: int, sync: bool) -> bool:
        if off > self.size:
            return False
        self.f.truncate(off)
        self.size = off
        if sync:
            self.f.flush()
            os.fdatasync(self.f.fileno())
        return True

    def sync(self) -> None:
        self.f.flush()
        os.fdatasync(self.f.fileno())

    def close(self):
        self.f.close()


def _configure(lib) -> None:
    """ctypes signatures of the native WAL's C ABI (the entries the
    hub calls; ``wal_write_at``/``wal_discard`` back actions the port's
    hub does not offer)."""
    lib.wal_open.restype = ctypes.c_void_p
    lib.wal_open.argtypes = [ctypes.c_char_p]
    lib.wal_close.argtypes = [ctypes.c_void_p]
    lib.wal_size.restype = ctypes.c_uint64
    lib.wal_size.argtypes = [ctypes.c_void_p]
    lib.wal_append.restype = ctypes.c_uint64
    lib.wal_append.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.wal_read.restype = ctypes.c_int64
    lib.wal_read.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
    ]
    lib.wal_truncate.restype = ctypes.c_int
    lib.wal_truncate.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
    ]


_wal_lock = threading.Lock()
_wal_lib = None
_wal_error: Optional[str] = None


def load_wal():
    """The native WAL's ctypes handle (built from ``csrc/wal.cpp`` at
    first use), or None when the build or the load fails; the failure
    is kept in ``wal_build_error()``."""
    global _wal_lib, _wal_error
    with _wal_lock:
        if _wal_lib is not None or _wal_error is not None:
            return _wal_lib
        from ..ops import native

        try:
            lib = native.load("wal")
            _configure(lib)
            _wal_lib = lib
        except Exception as e:  # no compiler, a failed build or load
            _wal_error = repr(e)
        return _wal_lib


def wal_build_error() -> Optional[str]:
    """Why the native WAL could not be loaded (None if it was, or was
    not tried yet)."""
    return _wal_error


class _NativeWal:
    """ctypes facade over ``csrc/wal.cpp`` with ``_PyWal``'s methods."""

    def __init__(self, lib, path: str):
        self.lib = lib
        self.h = lib.wal_open(path.encode())
        if not self.h:
            raise SummersetError(f"wal_open failed for {path}")

    @property
    def size(self) -> int:
        return self.lib.wal_size(self.h)

    def append(self, body: bytes, sync: bool) -> int:
        end = self.lib.wal_append(self.h, body, len(body), int(sync))
        if end == 0:
            raise SummersetError("wal_append failed")
        return end

    def read(self, off: int) -> Optional[Tuple[bytes, int]]:
        cap = 1 << 16
        while True:
            buf = (ctypes.c_uint8 * cap)()
            n = self.lib.wal_read(self.h, off, buf, cap)
            if n == -1:
                return None
            if n == -2:
                cap *= 4
                continue
            return ctypes.string_at(buf, int(n)), off + 8 + int(n)

    def truncate(self, off: int, sync: bool) -> bool:
        return self.lib.wal_truncate(self.h, off, int(sync)) == 0

    def sync(self) -> None:
        # truncate-to-current-size with sync=1 is a pure fsync (the
        # native surface has no separate sync entry point)
        if self.lib.wal_truncate(self.h, self.size, 1) != 0:
            raise SummersetError("wal fsync failed")

    def close(self):
        # idempotent: a second close would hand the native layer a freed
        # handle
        if self.h:
            self.lib.wal_close(self.h)
            self.h = None


class StorageHub:
    """Durable logger hub: submit actions, collect results in order.

    The channel API mirrors the reference hub (``submit_action``/
    ``get_result``, storage.rs:137-190); the logger thread owns the file.
    ``prefer_native`` opens the file with the native WAL (the Python
    mirror when its build fails); ``native`` says which backend did.
    """

    def __init__(self, path: str, registry=None, prefer_native: bool = True):
        lib = load_wal() if prefer_native else None
        self.backend = _NativeWal(lib, path) if lib else _PyWal(path)
        self.native = lib is not None
        if self.native:
            pf_info(logger, f"WAL {path}: native backend")
        elif prefer_native:
            pf_warn(logger, f"WAL {path}: Python backend (native WAL "
                            f"unavailable: {wal_build_error()})")
        else:
            pf_info(logger, f"WAL {path}: Python backend (asked for)")
        self._in: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue()
        self._stop_lock = threading.Lock()
        self._stopped = False
        # background group commit (the pipelined tick loop's durability
        # fence): fire-and-forget appends + token-stamped sync points.
        # The logger thread is a FIFO, so a token enqueued after a run
        # of appends covers exactly those appends; completion (or the
        # first error — a torn append, an EIO fsync) is published under
        # the condition and re-raised at wait_flush, BEFORE any frame or
        # reply gated on the token can leave the replica.
        self._flush_cv = threading.Condition()
        self._flush_next = 0          # tokens issued
        self._flush_done = 0          # tokens completed (monotonic)
        self._bg_error: Optional[BaseException] = None
        # telemetry seam (host/telemetry.MetricsRegistry): fsync latency
        # and the group-commit batch size
        self.registry = registry
        self._since_sync = 0
        # disk fault injection: a mutable spec consulted by the logger
        # thread before each action.  None = no faults.
        self._faults: Optional[dict] = None
        self._thread = threading.Thread(target=self._logger, daemon=True)
        self._thread.start()

    # -- fault injection -----------------------------------------------------
    def set_faults(self, spec: Optional[dict], seed: int = 0) -> None:
        """Arm (or clear, with ``spec=None``) disk-fault injection:

        - ``{"torn": 1}`` — the next append is torn: the record's bytes
          are only partially persisted (a crash mid-write) and the
          backend goes sticky-dead, so every later action fails too.
          The replica's group commit then raises, it crashes before any
          gated ack leaves, and recovery truncates the tear.
        - ``{"fsync_fail": n}`` — the next ``n`` sync points fail
          (EIO-style); the durability gate turns this into a crash.

        ``seed`` is accepted for interface symmetry with the JAX hub."""
        del seed
        self._faults = dict(spec) if spec else None

    # -- channel API ---------------------------------------------------------
    def submit_action(self, action_id: Any, action: LogAction) -> None:
        self._in.put((action_id, action))

    def get_result(self, timeout: Optional[float] = None):
        """Blocking next (action_id, LogResult)."""
        return self._out.get(timeout=timeout)

    def do_sync_action(self, action: LogAction) -> LogResult:
        """Run one action synchronously (recovery replay, serial loop)."""
        self.submit_action(None, action)
        aid, res = self.get_result()
        assert aid is None
        return res

    # -- background group commit (pipelined durability fence) ---------------
    def append_nowait(self, entry: Any) -> None:
        """Fire-and-forget unsynced append on the logger thread.  A
        failure is latched as the hub's background error and re-raised
        by the NEXT ``wait_flush``/``poll_flush``."""
        self._in.put((_BG_APPEND, LogAction("append", entry=entry,
                                            sync=False)))

    def flush_token(self) -> int:
        """Enqueue a background group-commit sync point covering every
        append submitted before it and return its token."""
        with self._flush_cv:
            self._flush_next += 1
            token = self._flush_next
        self._in.put(((_BG_FLUSH, token), LogAction("sync")))
        return token

    def poll_flush(self, token: int) -> bool:
        """Non-blocking fence probe: True iff ``token``'s sync point
        completed.  Raises the latched background error."""
        with self._flush_cv:
            if self._bg_error is not None:
                raise SummersetError(
                    f"WAL background group commit failed: {self._bg_error}"
                )
            return self._flush_done >= token

    def wait_flush(self, token: int, timeout: Optional[float] = None) -> None:
        """Block until ``token``'s sync point completed.  Raises the first
        background error, and :class:`SummersetError` on timeout."""
        with self._flush_cv:
            ok = self._flush_cv.wait_for(
                lambda: self._bg_error is not None
                or self._flush_done >= token,
                timeout=timeout,
            )
            if self._bg_error is not None:
                raise SummersetError(
                    f"WAL background group commit failed: {self._bg_error}"
                )
            if not ok:
                raise SummersetError(
                    f"WAL flush token {token} timed out after {timeout}s"
                )

    def stop(self) -> None:
        # idempotent and race-safe: the replica's own shutdown and an
        # external harness stop can both reach here
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._in.put(None)
        self._thread.join(timeout=5)
        self.backend.close()

    @property
    def size(self) -> int:
        return self.backend.size

    # -- logger thread -------------------------------------------------------
    def _inject_fault(self, a: LogAction) -> None:
        """Raise the armed fault for this action, mutating the disk state
        the way a real crash would (runs on the logger thread)."""
        f = self._faults
        if not f:
            return
        if f.get("dead"):
            raise OSError("injected: WAL device dead after torn write")
        if a.kind == "append" and f.get("torn", 0) > 0:
            f["torn"] -= 1
            b = self.backend
            body = pickle.dumps(a.entry)
            end = b.append(body, False)
            # keep the header + a body prefix on disk, what a crash
            # mid-write leaves behind
            b.truncate(end - max(1, len(body) // 2), True)
            f["dead"] = True
            raise OSError(
                "injected: torn append (crash mid-record write)"
            )
        if f.get("fsync_fail", 0) > 0 and (
            a.kind == "sync" or a.sync
        ):
            f["fsync_fail"] -= 1
            raise OSError("injected: fsync failed (EIO)")

    def _sync_point(self, fn):
        """Run a durability point, timed, closing the group-commit batch
        opened by the appends since the last sync."""
        t0 = time.monotonic()
        res = fn()
        reg = self.registry
        if reg is not None:
            reg.observe_s("wal_fsync_us", time.monotonic() - t0)
            reg.observe("wal_group_commit_batch", self._since_sync)
        self._since_sync = 0
        return res

    def _handle(self, a: LogAction) -> LogResult:
        self._inject_fault(a)
        b = self.backend
        if a.kind == "read":
            got = b.read(a.offset)
            if got is None:
                return LogResult("read", entry=None, end_offset=a.offset,
                                 offset_ok=False)
            body, end = got
            return LogResult("read", entry=pickle.loads(body),
                             end_offset=end)
        if a.kind == "append":
            if self.registry is not None:
                self.registry.counter_add("wal_appends_total")
            self._since_sync += 1
            data = pickle.dumps(a.entry)
            if a.sync:
                end = self._sync_point(lambda: b.append(data, True))
            else:
                end = b.append(data, False)
            return LogResult("append", end_offset=end)
        if a.kind == "truncate":
            ok = b.truncate(a.offset, a.sync)
            return LogResult("truncate", offset_ok=ok, now_size=b.size)
        if a.kind == "sync":
            # group commit: one fsync after a batch of sync=False appends
            self._sync_point(b.sync)
            return LogResult("sync", now_size=b.size)
        raise SummersetError(f"unknown log action kind {a.kind}")

    def _logger(self) -> None:
        while True:
            item = self._in.get()
            if item is None:
                return
            action_id, action = item
            # background channel: errors latch into _bg_error (sticky)
            # and surface at the fence
            if action_id == _BG_APPEND:
                try:
                    self._handle(action)
                except Exception as e:
                    with self._flush_cv:
                        if self._bg_error is None:
                            self._bg_error = e
                        self._flush_cv.notify_all()
                continue
            if isinstance(action_id, tuple) and action_id[0] == _BG_FLUSH:
                token = action_id[1]
                try:
                    self._handle(action)
                    with self._flush_cv:
                        self._flush_done = max(self._flush_done, token)
                        self._flush_cv.notify_all()
                except Exception as e:
                    with self._flush_cv:
                        if self._bg_error is None:
                            self._bg_error = e
                        self._flush_cv.notify_all()
                continue
            try:
                res = self._handle(action)
            except Exception as e:  # surface backend errors to the caller
                res = LogResult(action.kind, offset_ok=False, entry=e)
            self._out.put((action_id, res))
