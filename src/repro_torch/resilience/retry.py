"""Deadline-bounded retry with jittered exponential backoff.

The one retry primitive the hot paths share (admission hydration uses it
per profile). Deterministic: jitter comes from a seeded PRNG, and the
clock/sleep are injectable, so tests and the chaos bench replay exactly.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


@dataclass(frozen=True)
class RetryPolicy:
    """attempts total tries; delay_s * backoff**attempt between tries,
    capped at max_delay_s, each jittered by up to +jitter fraction;
    deadline_s bounds the WHOLE call (a retry that would start past the
    deadline is abandoned instead — serving latency stays bounded)."""
    attempts: int = 3
    delay_s: float = 0.005
    backoff: float = 2.0
    max_delay_s: float = 0.25
    jitter: float = 0.5
    deadline_s: float = 2.0


def retry_with_backoff(fn: Callable, *, policy: RetryPolicy = RetryPolicy(),
                       retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                       seed: int = 0,
                       sleep: Callable[[float], None] = time.sleep,
                       clock: Callable[[], float] = time.monotonic,
                       on_retry: Optional[Callable] = None):
    """Call `fn()` up to `policy.attempts` times within `policy.deadline_s`.

    Retries only on `retry_on` exceptions; anything else propagates at
    once. `on_retry(exc, attempt, delay)` is invoked before each sleep
    (callers count retries through it). Raises the last error when the
    attempts or the deadline run out.
    """
    if policy.attempts < 1:
        raise ValueError("RetryPolicy.attempts must be >= 1")
    rng = random.Random(seed)
    t0 = clock()
    last: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        try:
            return fn()
        except retry_on as exc:
            last = exc
            if attempt == policy.attempts - 1:
                break
            delay = min(policy.delay_s * policy.backoff ** attempt,
                        policy.max_delay_s)
            delay *= 1.0 + policy.jitter * rng.random()
            if clock() - t0 + delay > policy.deadline_s:
                break
            if on_retry is not None:
                on_retry(exc, attempt, delay)
            sleep(delay)
    assert last is not None
    raise last
