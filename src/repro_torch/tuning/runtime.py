"""Call-time plan resolution for the kernel wrappers (the reference's
``tuning/runtime.py``).

Precedence, highest first, as in the reference:

1. explicit arguments — a caller who passes ``bm=128`` always wins,
2. a cached tuned plan for this (kernel, problem, environment),
3. the built-in defaults (candidates.defaults_for).

The port's wrappers take only the first two from here
(``cached_pins``): a key neither passed nor cached stays unpinned, and
the wrapper resolves it as it did before tuning existed.  That matters
on the card, where a pin is not a default: ``spm_matmul`` sends any pin
other than its fixed-tile path's to the tiled kernel, so feeding the
default plan back as pins would move every decode product off split-K.
With no cache entry, or with ``REPRO_AUTOTUNE=0``, a wrapper passes no
pins and launches exactly what it launched before.

The cache consult is a dict lookup after the first call (one shared
``PlanCache`` per process, loaded lazily) and is disabled entirely with
``REPRO_AUTOTUNE=0`` — the tests run with it off so tier-1 never reads a
developer's cache.  On CUDA the lookup runs on the host when a call is
made, so in a captured graph it runs at the warm-up before capture and
a replay reads no cache.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional

from repro_torch.tuning.candidates import defaults_for
from repro_torch.tuning.plan import Plan, Problem
from repro_torch.tuning.plan_cache import PlanCache, cache_key, forget_env

AUTOTUNE_ENV = "REPRO_AUTOTUNE"

_active_cache: Optional[PlanCache] = None
_suspended = 0


def autotune_enabled() -> bool:
    return os.environ.get(AUTOTUNE_ENV, "1").lower() \
        not in ("0", "off", "false", "no")


def active_cache() -> PlanCache:
    """The process-wide plan cache (path from $REPRO_PLAN_CACHE)."""
    global _active_cache
    if _active_cache is None:
        _active_cache = PlanCache()
    return _active_cache


def reset(cache: Optional[PlanCache] = None) -> None:
    """Swap/clear the process cache and forget the environment read so
    far (tests: after changing env vars or patching the card)."""
    global _active_cache
    _active_cache = cache
    forget_env()


@contextlib.contextmanager
def cache_suspended() -> Iterator[None]:
    """Within it the wrappers consult no cache: the tuner's runners
    launch exactly the plan they time."""
    global _suspended
    _suspended += 1
    try:
        yield
    finally:
        _suspended -= 1


def cached_pins(kernel: str, problem: Problem,
                overrides: Dict[str, Optional[int]]) -> Plan:
    """The explicit (non-None) ``overrides``, and for each key left None
    the cached plan's value, if the cache holds one; no defaults."""
    explicit = {k: v for k, v in overrides.items() if v is not None}
    if len(explicit) < len(overrides) and not _suspended \
            and autotune_enabled():
        cached = active_cache().get(cache_key(kernel, problem))
        if cached is not None:
            return {**{k: v for k, v in cached.items()
                       if k in overrides and overrides[k] is None},
                    **explicit}
    return explicit


def resolve_plan(kernel: str, problem: Problem,
                 overrides: Dict[str, Optional[int]]) -> Plan:
    """Merge defaults <- cached plan <- explicit (non-None) args."""
    plan = defaults_for(kernel, problem)
    plan.update(cached_pins(kernel, problem, overrides))
    return plan
