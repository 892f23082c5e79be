"""Pluggable serving clocks: deterministic virtual time vs real wall time
(counterpart of ``repro.serve.clock``).

The serving engine charges time through exactly one seam — a
:class:`Clock` — so the *same* mechanism code (admission, stepping,
eviction, latency stamping) runs in two regimes:

* :class:`VirtualClock` (the default): the deterministic discrete-event
  clock the engine has always had.  Time advances **only** when the
  engine charges it (physical model evals x ``sec_per_eval``) or jumps
  it to the next arrival, so every latency/SLO number out of
  :func:`repro_torch.serve.scheduler.simulate` is a bit-reproducible function
  of the trace — no wall-clock noise, no threads.  ``charge()`` adds,
  ``wait_until()`` warps forward, ``now()`` reads the accumulator.

* :class:`MonotonicClock`: real time, for the asynchronous serving loop
  (:class:`repro_torch.serve.async_loop.AsyncServeLoop`).  ``now()`` reads
  ``time.monotonic()`` relative to the clock's epoch (so traces written
  as small offsets-from-zero replay unchanged), ``charge()`` is a no-op
  — real time passes on its own while the device computes — and
  ``wait_until()`` genuinely sleeps.  Numbers measured on this clock are
  wall-clock evidence and inherently noisy: compare ordering on it, not
  absolute seconds across runs.

The split keeps the repo's standing determinism guarantee intact:
``simulate()`` refuses non-virtual clocks (bit-determinism is its
contract), while the async loop accepts either — a ``VirtualClock``
async loop is how the pipelined dispatch/resolve path is tested
bit-exactly against the synchronous engine.
"""
from __future__ import annotations

import time

__all__ = ["Clock", "VirtualClock", "MonotonicClock"]


class Clock:
    """The engine's time seam.  ``is_wall`` tells deadline resolution
    which of a request's deadlines applies (``deadline`` is virtual
    seconds, ``deadline_wall`` is seconds on this clock — see
    :meth:`repro_torch.serve.diffusion.SampleRequest.absolute_deadline`)."""

    is_wall: bool = False

    def now(self) -> float:
        raise NotImplementedError

    def charge(self, seconds: float) -> None:
        """Account ``seconds`` of device compute against the clock."""
        raise NotImplementedError

    def wait_until(self, t: float) -> None:
        """Idle until the clock reads at least ``t`` (never backwards)."""
        raise NotImplementedError

    def reset(self) -> None:
        """Re-zero the clock (between back-to-back runs on one engine)."""
        raise NotImplementedError


class VirtualClock(Clock):
    """Deterministic discrete-event time: an accumulator the engine
    advances by charged eval cost.  ``simulate()`` requires this clock."""

    is_wall = False

    def __init__(self) -> None:
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def charge(self, seconds: float) -> None:
        self._t += seconds

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, t)

    def reset(self) -> None:
        self._t = 0.0


class MonotonicClock(Clock):
    """Real time via ``time.monotonic()``, zeroed at construction (or the
    last ``reset()``).  ``charge()`` is a no-op: wall time elapses while
    the device computes whether or not the host accounts for it."""

    is_wall = True

    def __init__(self) -> None:
        self._epoch = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._epoch

    def charge(self, seconds: float) -> None:
        pass

    def wait_until(self, t: float) -> None:
        delay = t - self.now()
        if delay > 0:
            time.sleep(delay)

    def reset(self) -> None:
        self._epoch = time.monotonic()
