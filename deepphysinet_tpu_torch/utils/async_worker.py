"""Single-daemon-thread work queue shared by the trainer's async paths.

One primitive backs both the async metric logger (tunnel fetches off the
dispatch loop) and the async checkpointer (device snapshot fetch + write off
the loop thread): a daemon worker draining a bounded queue, a first-error
latch re-raised on the caller thread, and a draining, idempotent ``close``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class AsyncWorker:
    """Run submitted thunks on one daemon thread; surface their errors.

    * ``submit(job)`` enqueues; raises any error latched from a PRIOR job.
    * ``wait()`` blocks until every submitted job finished, then re-raises
      any latched error.
    * ``close()`` drains the queue, stops the worker, re-raises any latched
      error. Idempotent; safe to call from a ``finally``.
    """

    def __init__(self, maxsize: int = 4):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue(
            maxsize=maxsize)
        self._err: Optional[BaseException] = None
        self._closed = False

        def run():
            while True:
                job = self._q.get()
                try:
                    if job is None:
                        return
                    try:
                        job()
                    except Exception as e:
                        if self._err is None:
                            self._err = e
                finally:
                    self._q.task_done()
                    job = None  # drop the job's captured references promptly

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def _raise(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, job: Callable[[], None]) -> None:
        if self._closed:
            raise RuntimeError("AsyncWorker is closed")
        self._raise()
        self._q.put(job)

    def full(self) -> bool:
        """True when a ``submit`` would block on the bounded queue.

        With a single producer this is race-free in the useful direction:
        the worker thread only DRAINS, so ``full() == False`` guarantees the
        producer's next ``submit`` does not block.  Callers use it to shed
        best-effort work (log fetches) under backpressure instead of letting
        a slow consumer throttle the producer loop.
        """
        return self._q.full()

    def wait(self) -> None:
        """Block until every submitted job is done; re-raise latched errors."""
        self._q.join()
        self._raise()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._t.join()
        self._raise()

    def close_quietly(self) -> None:
        """``close()`` for ``finally`` blocks: never raises (prints instead),
        so a shutdown error cannot mask the exception being propagated."""
        try:
            self.close()
        except Exception as e:
            print(f"warning: async worker shutdown error: {e}")
