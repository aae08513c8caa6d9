"""The one retry policy for the serving tier.

A copy of ``koordinator_tpu/replication/retry.py`` (pure Python).

Every reconnect/failover loop in the tier — the follower's replication
redial, the Python client's Sync/read retries, the promotion probe —
retries through this module instead of hand-rolling ``time.sleep`` in
a loop.  Three properties a bare fixed-sleep loop lacks, each of which
has a production failure mode named after it:

* **jitter** — a leader restart wakes every follower and client at
  once; synchronized fixed sleeps re-arrive as a thundering herd at
  exactly the moment the new leader is coldest.  Every delay here is
  multiplied by ``uniform(1 - jitter, 1)``.
* **exponential growth with a cap** — a dead peer is polled at the
  base delay first (fast failover when the restart is fast) and at
  ``cap_ms`` forever after (a dead peer costs polls, not a spin).
* **a deadline budget** — retries stop when the budget is spent and
  the LAST error surfaces to the caller; an unbounded loop turns an
  outage into a hang nobody can distinguish from a deadlock.

Env knobs (the client and daemon both read them through
:func:`BackoffPolicy.from_env`): ``KOORD_RETRY_BASE_MS``,
``KOORD_RETRY_CAP_MS``, ``KOORD_RETRY_DEADLINE_MS``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable, Iterator, Optional

DEFAULT_BASE_MS = 25.0
DEFAULT_CAP_MS = 2_000.0
DEFAULT_DEADLINE_MS = 15_000.0


def _env_float(name: str, default: float) -> float:
    # `or`: an empty env value means unset (the KOORD_* convention),
    # and a malformed one must degrade to the default, not crash a
    # daemon at boot
    try:
        return float(os.environ.get(name) or default)
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Jittered exponential backoff under a total deadline budget.

    ``base_ms`` doubles per attempt up to ``cap_ms``; every delay is
    jittered down by up to ``jitter`` (fraction).  ``deadline_ms`` is
    the TOTAL budget across all attempts — :meth:`delays` stops
    yielding once spending the next delay would cross it.
    ``deadline_ms=0`` means one attempt, no retries."""

    base_ms: float = DEFAULT_BASE_MS
    cap_ms: float = DEFAULT_CAP_MS
    deadline_ms: float = DEFAULT_DEADLINE_MS
    multiplier: float = 2.0
    jitter: float = 0.5

    @classmethod
    def from_env(cls, **overrides) -> "BackoffPolicy":
        kw = dict(
            base_ms=_env_float("KOORD_RETRY_BASE_MS", DEFAULT_BASE_MS),
            cap_ms=_env_float("KOORD_RETRY_CAP_MS", DEFAULT_CAP_MS),
            deadline_ms=_env_float(
                "KOORD_RETRY_DEADLINE_MS", DEFAULT_DEADLINE_MS
            ),
        )
        kw.update(overrides)
        return cls(**kw)

    def delay_ms(self, attempt: int, rng: Callable[[], float] = random.random) -> float:
        """The jittered delay before retry ``attempt`` (0-based)."""
        raw = min(
            float(self.cap_ms),
            float(self.base_ms) * (self.multiplier ** attempt),
        )
        span = max(0.0, min(1.0, float(self.jitter)))
        return raw * (1.0 - span * rng())

    def delays(
        self,
        clock: Callable[[], float] = time.monotonic,
        rng: Callable[[], float] = random.random,
    ) -> Iterator[float]:
        """Yield the delay to sleep before each RETRY, respecting the
        deadline budget: the first attempt is free (callers try once
        before consulting the iterator), and iteration ends when the
        next delay would land past the budget."""
        start = clock()
        attempt = 0
        while True:
            d_ms = self.delay_ms(attempt, rng)
            spent_ms = (clock() - start) * 1000.0
            if spent_ms + d_ms > self.deadline_ms:
                return
            attempt += 1
            yield d_ms


def call_with_retry(
    fn: Callable[[], object],
    policy: BackoffPolicy,
    retryable: Callable[[BaseException], bool],
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn`` until it returns, a non-retryable error raises, or
    the policy's deadline budget is spent (the LAST error surfaces).
    ``on_retry(attempt, exc)`` observes each retry (metrics hooks)."""
    delays = policy.delays(clock=clock)
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as exc:
            if not retryable(exc):
                raise
            d_ms = next(delays, None)
            if d_ms is None:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            attempt += 1
            sleep(d_ms / 1000.0)
