"""Latency distribution statistics (paper Figure 2: tail latency).

The paper's key systems observation is not about means alone: DAAT means can
beat SAAT while DAAT's p99/max explode on ill-behaved queries. We therefore
always report the full Tukey summary.

This module also owns the serving layer's *time source*: every component that
measures or schedules against wall time (``AnytimeServer``'s cost model, the
``AdmissionQueue``'s deadline-driven flush policy) reads an injectable
:class:`Clock` instead of calling ``time.perf_counter`` directly. Production
uses :class:`SystemClock`; tests drive a :class:`SimulatedClock` so
time-dependent policy (EMA calibration, flush-before-deadline) is exercised
deterministically.

A copy of ``repro.metrics.latency`` (numpy only), so the port imports
nothing of the reference. A clock measures the host; the serving layer
synchronises the device before it reads one, so a reading covers the
device's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Protocol, runtime_checkable

import numpy as np


# --------------------------------------------------------------------------
# clocks
# --------------------------------------------------------------------------


@runtime_checkable
class Clock(Protocol):
    """Monotonic time source, in seconds. The serving layer's only clock."""

    def now(self) -> float:  # pragma: no cover - protocol
        ...


class SystemClock:
    """Wall clock: ``time.perf_counter`` (monotonic, high resolution)."""

    def now(self) -> float:
        return time.perf_counter()


class SimulatedClock:
    """Deterministic clock for tests: time moves only via ``advance``.

    ``advance_to`` never moves time backwards, so a driver can safely jump to
    ``max(next_arrival, queue.next_due())`` event times in any order.
    """

    def __init__(self, start_s: float = 0.0):
        self._t = float(start_s)

    def now(self) -> float:
        return self._t

    def advance(self, dt_s: float) -> float:
        if dt_s < 0:
            raise ValueError(f"cannot advance by negative dt {dt_s}")
        self._t += dt_s
        return self._t

    def advance_to(self, t_s: float) -> float:
        self._t = max(self._t, float(t_s))
        return self._t


class HybridClock(SimulatedClock):
    """Simulated schedule + real measured work: every ``now()`` also accrues
    the wall time elapsed since the previous call.

    Replay drivers jump between arrival/due events with ``advance_to`` (never
    backwards) exactly like :class:`SimulatedClock`, but any real computation
    between calls — a search, host-side padding — advances time by its
    measured duration. Cost-model calibration therefore sees real service
    times and deadline-policy accounting becomes falsifiable, while the
    arrival schedule stays scripted. Under overload, time outruns the
    schedule and arrivals are admitted late (closed-loop load semantics) —
    use a pure :class:`SimulatedClock` when determinism matters more than
    realism.
    """

    def __init__(self, start_s: float = 0.0):
        super().__init__(start_s)
        self._last_real = time.perf_counter()

    def _accrue(self):
        r = time.perf_counter()
        self._t += r - self._last_real
        self._last_real = r

    def now(self) -> float:
        self._accrue()
        return self._t

    def advance(self, dt_s: float) -> float:
        self._accrue()
        return super().advance(dt_s)

    def advance_to(self, t_s: float) -> float:
        self._accrue()
        return super().advance_to(t_s)


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    mean_ms: float
    p50_ms: float
    p75_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    std_ms: float
    n: int

    def row(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def tail_ratio(self) -> float:
        """p99 / p50 — the predictability figure of merit."""
        return self.p99_ms / max(self.p50_ms, 1e-9)


def summarize_latencies(latencies_ms) -> LatencyStats:
    x = np.asarray(list(latencies_ms), dtype=np.float64)
    if x.size == 0:
        return LatencyStats(0, 0, 0, 0, 0, 0, 0, 0)
    return LatencyStats(
        mean_ms=float(x.mean()),
        p50_ms=float(np.percentile(x, 50)),
        p75_ms=float(np.percentile(x, 75)),
        p95_ms=float(np.percentile(x, 95)),
        p99_ms=float(np.percentile(x, 99)),
        max_ms=float(x.max()),
        std_ms=float(x.std()),
        n=int(x.size),
    )
