"""ControlHub: the server's channel to the cluster manager, counterpart
of ``summerset_tpu/host/control.py``.

Parity: reference ``src/server/control.rs`` — connect to the manager, read
the assigned ``(id, population)`` handshake, then exchange framed
``CtrlMsg``s through send/recv queues owned by a messenger task
(control.rs:19-252).  Deviation: the handshake rides a normal frame rather
than 2 raw bytes (symmetric framing everywhere).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Optional, Tuple

from ..utils import safetcp
from ..utils.errors import SummersetError
from ..utils.logging import pf_logger, set_me
from .messages import CtrlMsg

logger = pf_logger("control")


class ControlHub:
    def __init__(self, manager_addr: Tuple[str, int], timeout: float = 15.0):
        # handshake with retry: during a crash-restart the manager may not
        # have reaped our old connection yet, in which case it finds no
        # free id and closes the fresh connection — retry until it does
        # (reference servers retry manager connects too, control.rs:43)
        import time

        deadline = time.monotonic() + 60.0
        self.sock = None
        while True:
            try:
                self.sock = socket.create_connection(
                    manager_addr, timeout=timeout
                )
                self.sock.settimeout(timeout)
                me_id, population = safetcp.recv_msg_sync(self.sock)
                self.sock.settimeout(None)
                break
            except (OSError, EOFError, SummersetError):
                if self.sock is not None:
                    try:
                        self.sock.close()
                    except OSError:
                        pass
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self.me: int = int(me_id)
        self.population: int = int(population)
        set_me(str(self.me))
        self._recv: queue.Queue = queue.Queue()
        self._alive = True
        self._reader = threading.Thread(target=self._recv_loop, daemon=True)
        self._reader.start()
        self._wlock = threading.Lock()

    def send_ctrl(self, msg: CtrlMsg) -> None:
        # graftlint: disable=H101 -- per-socket writer serialization is this lock's whole job: concurrent send_ctrl callers must not interleave frame bytes on the one manager socket
        with self._wlock:
            safetcp.send_msg_sync(self.sock, msg)

    def recv_ctrl(self, timeout: Optional[float] = None) -> CtrlMsg:
        msg = self._recv.get(timeout=timeout)
        if msg is None:
            raise SummersetError("manager connection closed")
        return msg

    def try_recv_ctrl(self) -> Optional[CtrlMsg]:
        try:
            msg = self._recv.get_nowait()
        except queue.Empty:
            return None
        if msg is None:
            raise SummersetError("manager connection closed")
        return msg

    def close(self) -> None:
        self._alive = False
        # shutdown() BEFORE close(): the reader thread is blocked in
        # recv() holding a reference to the file description, so a bare
        # close() only drops our fd — no FIN is ever sent and the
        # manager keeps the dead connection (and our id!) forever,
        # wedging every rejoin attempt of a self-crashed replica in the
        # handshake retry loop.  shutdown() tears the connection down
        # immediately regardless of the concurrent recv.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def _recv_loop(self) -> None:
        try:
            while self._alive:
                self._recv.put(safetcp.recv_msg_sync(self.sock))
        except Exception:
            self._recv.put(None)
