"""Retry with jittered exponential backoff for *transient* failures (a
copy of the reference's ``resilience/retry.py``).

Scope discipline: this wraps only operations whose failures are
plausibly transient (filesystem hiccups, NFS timeouts — `OSError`
family).  Corruption is NOT transient: a checksum mismatch or a
mis-shaped manifest will fail identically on every attempt, so those
raise distinct exception types that deliberately do not appear in
``retry_on`` (checkpoint fallback handles them instead).

The backoff jitter is drawn from a *seeded* RNG by default: two runs
of the same fault plan retry at the same simulated schedule, which is
what makes the chaos harness deterministic end-to-end.
"""
from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Tuple, Type

# module-level seeded stream: deterministic across runs, shared across
# call sites within one process (the order of I/O ops is itself
# deterministic under a fault plan)
_JITTER_RNG = random.Random(0xA11CE)


class RetriesExhausted(RuntimeError):
    """All attempts failed; ``__cause__`` is the last underlying error."""


def retry_transient(
    fn: Callable[[], Any],
    attempts: int = 3,
    base_delay: float = 0.01,
    max_delay: float = 1.0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    give_up_on: Tuple[Type[BaseException], ...] = (),
    jitter: float = 0.5,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Call ``fn()`` up to ``attempts`` times, backing off between
    failures by ``base_delay * 2**k`` scaled by up to ``1 + jitter``
    (capped at ``max_delay``).

    ``on_retry(attempt, exc, delay_s)`` fires before each sleep — the
    checkpoint layer uses it to emit an ``io_retry`` trace instant so
    recoveries are visible in the Chrome trace.  The final failure
    re-raises the underlying exception wrapped in
    :class:`RetriesExhausted` so callers can distinguish "gave up"
    from a first-try hard error.

    ``give_up_on`` carves exceptions back out of ``retry_on``:
    ``FileNotFoundError`` is an ``OSError``, but a missing file is
    deterministic damage, not a blip — retrying it only delays the
    corruption handler.
    """
    assert attempts >= 1, attempts
    rng = _JITTER_RNG if rng is None else rng
    delay = base_delay
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except give_up_on:
            raise
        except retry_on as e:
            if attempt == attempts:
                raise RetriesExhausted(
                    f"{attempts} attempts failed; last: {e!r}") from e
            d = min(max_delay, delay) * (1.0 + jitter * rng.random())
            if on_retry is not None:
                on_retry(attempt, e, d)
            sleep(d)
            delay *= 2.0
