"""Event-loop teardown helper shared by the asyncio-owning hubs."""

from __future__ import annotations

import asyncio


def drain_and_close(loop: asyncio.AbstractEventLoop) -> None:
    """Cancel every pending task, let cancellations run, close the loop.

    Prevents the 'Task was destroyed but it is pending!' / 'Event loop is
    closed' teardown spray from orphaned tickers, servants, and in-flight
    sends (used by ExternalApi and the test harness's manager thread)."""
    try:
        pending = asyncio.all_tasks(loop)
        for task in pending:
            task.cancel()
        if pending:
            loop.run_until_complete(
                asyncio.gather(*pending, return_exceptions=True)
            )
    except Exception:
        pass
    loop.close()
