"""A lock granted in the order it was asked for."""

from __future__ import annotations

import threading


class FairLock:
    """A first-come, first-served lock (a ticket lock). threading.Lock is
    not fair: a thread that releases it and asks for it again at once, as
    the trainer does between steps, can take it again while another thread
    waits. Not reentrant."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._next = 0  # the next ticket handed out
        self._serving = 0  # the ticket holding the lock

    def acquire(self) -> None:
        with self._cond:
            ticket = self._next
            self._next += 1
            while self._serving != ticket:
                self._cond.wait()

    def release(self) -> None:
        with self._cond:
            self._serving += 1
            self._cond.notify_all()

    def locked(self) -> bool:
        with self._cond:
            return self._serving != self._next

    def __enter__(self) -> "FairLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
