"""Node anomaly detector: a circuit-breaker style state machine.

A host-only copy of ``koordinator_tpu/descheduler/anomaly.py`` (reference
``pkg/descheduler/utils/anomaly/basic_detector.go``): ``Mark`` feeds
normal/abnormal observations; consecutive abnormalities trip the detector
into the anomaly state, consecutive normalities restore it, and a timeout
rolls the generation so stale counts do not linger.  LowNodeLoad uses it
to debounce eviction decisions (``low_node_load.go:256
filterRealAbnormalNodes``).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional


class State(enum.Enum):
    OK = "ok"
    ANOMALY = "anomaly"


@dataclasses.dataclass
class Counter:
    """Mirror of the reference's Counter: totals plus consecutive runs."""

    total: int = 0
    normalities: int = 0
    abnormalities: int = 0
    consecutive_normalities: int = 0
    consecutive_abnormalities: int = 0

    def on_normal(self):
        self.total += 1
        self.normalities += 1
        self.consecutive_normalities += 1
        self.consecutive_abnormalities = 0

    def on_abnormal(self):
        self.total += 1
        self.abnormalities += 1
        self.consecutive_abnormalities += 1
        self.consecutive_normalities = 0

    def clear(self):
        self.total = 0
        self.normalities = 0
        self.abnormalities = 0
        self.consecutive_normalities = 0
        self.consecutive_abnormalities = 0


# defaults per reference basic_detector.go:28-34
def default_anomaly_condition(c: Counter) -> bool:
    return c.consecutive_abnormalities > 5


def default_normal_condition(c: Counter) -> bool:
    return c.consecutive_normalities > 3


class BasicDetector:
    """State machine with a generation timeout (reference
    ``BasicDetector``): observations older than ``timeout`` roll into a new
    generation with cleared counters."""

    def __init__(
        self,
        name: str,
        timeout_seconds: float = 60.0,
        anomaly_condition: Optional[Callable[[Counter], bool]] = None,
        normal_condition: Optional[Callable[[Counter], bool]] = None,
        on_state_change: Optional[Callable[[str, State, State], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.timeout = timeout_seconds if timeout_seconds > 0 else 60.0
        self._anomaly_cond = anomaly_condition or default_anomaly_condition
        self._normal_cond = normal_condition or default_normal_condition
        self._on_state_change = on_state_change
        self._clock = clock
        self._state = State.OK
        self.counter = Counter()
        # seeded on the FIRST observation, in the caller's time base: the
        # constructor's wall clock and a caller-driven simulated ``now``
        # would otherwise mix bases and roll generations spuriously
        self._expiration: Optional[float] = None

    def state(self, now: Optional[float] = None) -> State:
        self._maybe_roll_generation(now)
        return self._state

    def mark(self, normality: bool, now: Optional[float] = None) -> State:
        """Feed one observation; returns the post-observation state.
        ``now`` overrides the clock for callers driving simulated time."""
        self._maybe_roll_generation(now)
        if normality:
            self.counter.on_normal()
            if self._state is State.ANOMALY and self._normal_cond(self.counter):
                self._set_state(State.OK, now)
        else:
            self.counter.on_abnormal()
            if self._state is State.OK and self._anomaly_cond(self.counter):
                self._set_state(State.ANOMALY, now)
        return self._state

    def reset(self):
        """Back to OK with cleared counters (reference ``Reset``)."""
        self.counter.clear()
        self._set_state(State.OK)
        self._expiration = None

    def _maybe_roll_generation(self, now: Optional[float] = None):
        now = self._clock() if now is None else now
        if self._expiration is None:
            self._expiration = now + self.timeout
            return
        if now >= self._expiration:
            self.counter.clear()
            self._expiration = now + self.timeout

    def _set_state(self, new: State, now: Optional[float] = None):
        old = self._state
        if old is new:
            return
        self._state = new
        self._expiration = (self._clock() if now is None else now) + self.timeout
        if self._on_state_change:
            self._on_state_change(self.name, old, new)
