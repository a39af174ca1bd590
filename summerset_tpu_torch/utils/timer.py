"""Resettable asynchronous timeout timer (host side).

Parity: reference ``src/utils/timer.rs:39-143`` (``Timer::new/kickoff/extend/
cancel/exploded``) — the backbone of heartbeats, leases and client timeouts in
the host runtime.  Implemented over asyncio instead of a spawned tokio task.

Device-side timers are *not* this class: vectorized protocols represent
timeouts as per-(group, replica) integer countdown arrays decremented each
tick with PRNG jitter (see ``summerset_tpu.ops.prng`` and protocol kernels),
mirroring how randomized hear-timeout ranges (``heartbeat.rs:96-116``) become
jittered countdown reloads.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional


class Timer:
    """One-shot resettable timer.

    - ``kickoff(dur)``: (re)start the countdown; cancels a pending one.
    - ``extend(dur)``: push the deadline further out without restarting flags.
    - ``cancel()``: stop without exploding.
    - ``exploded``: True once the deadline passed without cancel/restart.
    - optionally fires a callback and/or sets an asyncio.Event on explosion.
    """

    def __init__(
        self,
        explode_callback: Optional[Callable[[], None]] = None,
        explode_async: Optional[Callable[[], Awaitable[None]]] = None,
    ):
        self._cb = explode_callback
        self._acb = explode_async
        self._task: Optional[asyncio.Task] = None
        self._deadline: float = 0.0
        self._exploded = asyncio.Event()

    @property
    def exploded(self) -> bool:
        return self._exploded.is_set()

    async def wait_exploded(self) -> None:
        await self._exploded.wait()

    def kickoff(self, dur_secs: float) -> None:
        self.cancel()
        loop = asyncio.get_event_loop()
        self._deadline = loop.time() + dur_secs
        self._exploded.clear()
        self._task = loop.create_task(self._run())

    def extend(self, dur_secs: float) -> None:
        """Push the current deadline out by ``dur`` (kickoff if not ticking).

        Parity: reference ``timer.rs:94`` does ``*ddl += dur``.
        """
        if self._task is None or self._task.done():
            self.kickoff(dur_secs)
        else:
            self._deadline += dur_secs

    def cancel(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
        self._task = None
        self._exploded.clear()

    async def _run(self) -> None:
        loop = asyncio.get_event_loop()
        try:
            while True:
                now = loop.time()
                if now >= self._deadline:
                    break
                await asyncio.sleep(self._deadline - now)
            self._exploded.set()
            if self._cb is not None:
                self._cb()
            if self._acb is not None:
                await self._acb()
        except asyncio.CancelledError:
            pass
