"""The event loop of the synchronous client API, on a thread of its own
(petals_tpu/client/runtime.py). The swarm stack (DHT, RPC, sessions) is
asyncio; the model classes are synchronous. A client in the same process as
servers keeps its loop off theirs."""

from __future__ import annotations

import asyncio
import threading
from typing import Awaitable, Optional, TypeVar

T = TypeVar("T")


class SwarmRuntime:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name="ptu-torch-client-loop", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro: Awaitable[T], timeout: Optional[float] = None) -> T:
        future = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return future.result(timeout)

    def shutdown(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=10)
        if not self._thread.is_alive():
            self.loop.close()
