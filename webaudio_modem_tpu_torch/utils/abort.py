"""Cancellation primitives: AbortController / AbortSignal for asyncio.

The port's copy of ``webaudio_modem_tpu/utils/abort.py``, with the same
semantics: DOM-style AbortSignal on asyncio with synchronous listener
dispatch, timeout signals, ``AbortSignal.any`` composition, the lazy
``timeout_any`` composite on a shared timer wheel, and ``race_abort``.
"""

from __future__ import annotations

import asyncio
import math
import time
import weakref
from typing import Any, Awaitable, Callable, Iterable, List, Optional, TypeVar


class AbortError(Exception):
    """Raised when an operation is aborted."""

    name = "AbortError"

    def __init__(self, message: str = "Operation aborted", reason: Any = None):
        super().__init__(message)
        self.reason = reason


class AbortSignal:
    def __init__(self) -> None:
        self._aborted = False
        self._reason: Any = None
        self._listeners: List[Callable[[], None]] = []
        self._event: Optional[asyncio.Event] = None
        self._cleanup: List[Callable[[], None]] = []

    @property
    def aborted(self) -> bool:
        return self._aborted

    @property
    def reason(self) -> Any:
        return self._reason

    def add_listener(self, callback: Callable[[], None],
                     once: bool = True) -> None:
        """Register an abort listener (fired synchronously; listeners are
        one-shot, matching DOM ``{once: true}`` usage in the reference)."""
        if self._aborted:
            callback()
            return
        self._listeners.append(callback)

    def remove_listener(self, callback: Callable[[], None]) -> None:
        if callback in self._listeners:
            self._listeners.remove(callback)

    def throw_if_aborted(self) -> None:
        if self._aborted:
            raise AbortError(reason=self._reason)

    def _do_abort(self, reason: Any = None) -> None:
        if self._aborted:
            return
        self._aborted = True
        self._reason = reason
        listeners, self._listeners = self._listeners, []
        for cb in listeners:
            cb()
        if self._event is not None:
            self._event.set()

    def detach(self) -> None:
        """Release externally held resources: composite signals
        (``any``) unregister from their children, timeout signals cancel
        their loop timer.  Call when a per-operation signal is no longer
        needed — long-running transports create one composite per wait,
        and without detaching, listeners/timers accumulate on the
        long-lived external signal and the event loop."""
        cleanup, self._cleanup = self._cleanup, []
        for fn in cleanup:
            fn()

    async def wait(self) -> None:
        """Await until this signal aborts (never resolves otherwise)."""
        if self._aborted:
            return
        if self._event is None:
            self._event = asyncio.Event()
            if self._aborted:  # abort raced with event creation
                self._event.set()
        await self._event.wait()

    @staticmethod
    def timeout(ms: float) -> "AbortSignal":
        """Signal that aborts after ``ms`` milliseconds
        (DOM ``AbortSignal.timeout`` analog)."""
        signal = AbortSignal()
        loop = asyncio.get_running_loop()
        handle = loop.call_later(
            ms / 1000.0, lambda: signal._do_abort(TimeoutError("timeout")))
        # Cancel the timer once aborted from elsewhere (no-op if it
        # fired) and on detach.
        signal.add_listener(handle.cancel)
        signal._cleanup.append(handle.cancel)
        return signal

    @staticmethod
    def any(signals: Iterable["AbortSignal"]) -> "AbortSignal":
        """Composite signal aborting when any child aborts
        (DOM ``AbortSignal.any`` analog)."""
        combined = AbortSignal()
        for s in signals:
            if s.aborted:
                combined._do_abort(s.reason)
                return combined
        for s in signals:
            cb = (lambda s=s: combined._do_abort(s.reason))
            s.add_listener(cb)
            combined._cleanup.append(
                lambda s=s, cb=cb: s.remove_listener(cb))
        return combined

    @staticmethod
    def timeout_any(ms: float,
                    parents: Iterable["AbortSignal"]) -> "AbortSignal":
        """``any([timeout(ms), *parents])`` as ONE signal — the
        per-protocol-wait fast path.  The generic composition
        allocates 2-3 signals plus ~8 closures per wait, once per
        protocol wait of every concurrent session.  Semantics are
        identical:
        aborts with TimeoutError reason after ``ms``, or with the
        parent's reason when any parent aborts; ``detach()`` cancels
        the timer and unhooks the parents."""
        return _TimeoutAny(ms, tuple(parents))


class _TimerWheel:
    """Coarse shared timers for long delays: ONE ``call_at`` per 100 ms
    bucket instead of one ``call_later`` per protocol wait.

    With thousands of concurrent ARQ sessions every wait parks a
    multi-second timeout that almost never fires; per-wait
    ``call_later`` would keep a timer heap of that many entries.
    A bucket fires at most 100 ms late — never early — which is
    immaterial for multi-second protocol timeouts; sub-second delays
    don't use the wheel (plain ``call_later``, full precision).
    Detached signals are skipped at fire time (no unschedule); a
    bucket holds its refs until its deadline passes."""

    GRAN = 0.1
    MIN_DELAY = 1.0

    __slots__ = ("_loop", "_buckets")

    def __init__(self, loop) -> None:
        self._loop = loop
        self._buckets: dict = {}

    def schedule(self, delay: float, sig: "_TimeoutAny") -> None:
        key = math.ceil((self._loop.time() + delay) / self.GRAN)
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = []
            self._loop.call_at(key * self.GRAN, self._fire, key)
        b.append(sig)

    def _fire(self, key: int) -> None:
        for sig in self._buckets.pop(key, ()):
            sig._fire_timeout()      # no-op when aborted/detached


_WHEELS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _wheel_for(loop) -> _TimerWheel:
    wheel = _WHEELS.get(loop)
    if wheel is None:
        wheel = _WHEELS[loop] = _TimerWheel(loop)
    return wheel


class _TimeoutAny(AbortSignal):
    """LAZY composite: the timer and the parent-listener hookup happen
    on first blocking use (``add_listener``/``wait`` — i.e. when a
    protocol wait actually parks), not at construction.  Roughly half
    the farm byte waits resolve on the sync fast path (the item is
    already queued) and never block; for those the
    whole signal lifecycle is two flag checks and a parent scan.  The
    timeout clock therefore starts at the first park — at most LATER
    than at construction (by the microseconds spent on fast-path
    reads), never earlier, the same late-never-early contract as the
    timer wheel's bucketing."""

    def __init__(self, ms: float, parents: tuple) -> None:
        super().__init__()
        self._parents = parents
        self._handle = None
        self._dead = False
        self._deadline = time.monotonic() + ms / 1000.0
        self._armed = False

    def _arm(self) -> None:
        """Schedule the async notification machinery (wheel/timer +
        parent listeners).  Needed only when someone will be NOTIFIED
        (listener attached / wait parked); instant observations
        (``aborted``/``throw_if_aborted``) are answered by
        ``_sync_lazy`` arithmetic without ever arming."""
        if self._armed or self._dead or self._aborted:
            return
        self._armed = True
        loop = asyncio.get_running_loop()
        delay = self._deadline - time.monotonic()
        if delay <= 0:
            self._fire_timeout()
            return
        if delay >= _TimerWheel.MIN_DELAY:
            _wheel_for(loop).schedule(delay, self)
        else:
            self._handle = loop.call_later(delay, self._fire_timeout)
        fire = self._fire_parent
        for p in self._parents:
            p.add_listener(fire)       # calls back NOW if p aborted
            if self._aborted:
                break

    def _sync_lazy(self) -> None:
        """Un-armed instant observation: reflect parent aborts and the
        deadline by arithmetic (no timers, no listeners)."""
        if self._aborted or self._armed:
            return
        self._fire_parent()
        if not self._aborted and time.monotonic() >= self._deadline:
            self._fire_timeout()

    @property
    def aborted(self) -> bool:
        self._sync_lazy()
        return self._aborted

    @property
    def reason(self) -> Any:
        return self._reason

    def add_listener(self, callback: Callable[[], None],
                     once: bool = True) -> None:
        self._sync_lazy()
        if not self._aborted:
            self._arm()
        super().add_listener(callback, once)

    def throw_if_aborted(self) -> None:
        self._sync_lazy()
        super().throw_if_aborted()

    async def wait(self) -> None:
        self._sync_lazy()
        if not self._aborted:
            self._arm()
        await super().wait()

    def _fire_timeout(self) -> None:
        if not self._dead:
            self._do_abort(TimeoutError("timeout"))

    def _fire_parent(self) -> None:
        # reads ``p._aborted`` as the JAX package does, not the lazy
        # ``aborted`` property: a lazy parent that has not synced is not
        # seen here (kept for parity; ROADMAP queue 3)
        for p in self._parents:
            if p._aborted:
                self._do_abort(p._reason)
                return

    def _do_abort(self, reason: Any = None) -> None:
        if self._aborted:
            return
        self._dead = True
        if self._handle is not None:
            self._handle.cancel()
        super()._do_abort(reason)

    def detach(self) -> None:
        self._dead = True
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        if self._armed:
            fire = self._fire_parent
            for p in self._parents:
                p.remove_listener(fire)
        # the timer wheel holds this object until its bucket's deadline
        # passes (by design, no unschedule) — drop every outgoing ref
        # so what it retains is a bare husk, not the parent signals /
        # waiter closures behind a whole protocol wait
        self._parents = ()
        super().detach()
        self._listeners.clear()


class AbortController:
    def __init__(self) -> None:
        self.signal = AbortSignal()

    def abort(self, reason: Any = None) -> None:
        self.signal._do_abort(reason)


T = TypeVar("T")


async def race_abort(awaitable: Awaitable[T],
                     signal: Optional[AbortSignal]) -> T:
    """Run ``awaitable``, raising AbortError as soon as ``signal`` aborts.

    The analog of a promise-vs-abort race; the losing task is cancelled.

    Implemented as a synchronous abort listener that cancels the task,
    not as a second ``signal.wait()`` task plus ``asyncio.wait``: every
    protocol hop of every concurrent session goes through here, and the
    listener form creates one task where the race creates two.
    """
    if signal is None:
        return await awaitable
    signal.throw_if_aborted()
    task = asyncio.ensure_future(awaitable)

    def on_abort() -> None:
        if not task.done():
            task.cancel()

    signal.add_listener(on_abort)
    try:
        return await task
    except asyncio.CancelledError:
        if signal.aborted:
            raise AbortError(reason=signal.reason)
        raise
    finally:
        signal.remove_listener(on_abort)
        # the caller itself being cancelled mid-await cancels ``task``
        # (asyncio cancels the awaited future); this covers exotic
        # wrappers where it might not
        if not task.done():
            task.cancel()
