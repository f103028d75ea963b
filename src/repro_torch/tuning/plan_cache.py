"""Persistent JSON plan cache (the reference's ``tuning/plan_cache.py``,
keyed on the port's own environment).

Tuning is offline (paper §4.3: decisions are made ahead of execution),
so winning plans persist to disk and subsequent runs — the CLI, the
serve driver, and the kernel wrappers themselves — hit the cache with
zero measurements.

Keying: ``kernel|problem.sig|env`` where ``env`` is a digest of the
environment fields of ``repro_torch.obs.report.hw_fingerprint()``: the
reference's ``python``, ``platform``, ``machine`` and ``numpy``, then
``torch`` in place of ``jax``, and in place of ``backend`` the card
(``compat.device_identity()``: CUDA version, device name, capability,
power limit).  A plan tuned on the CPU (``gpu: None``) never resolves on
an sm_90 card, and a plan tuned under one power limit never resolves
under another.  Model-level serving plans (tuning.model) live in the
same store under the ``model|...`` namespace.  A file the reference
wrote loads here (same schema) but none of its keys resolves: its
digest is over other fields.

Schema v2 (the ``model|`` namespace) only widened the key space; entry
shape is unchanged, so v1 files load without warnings
(``_ACCEPTED_SCHEMA_VERSIONS``).

The cache degrades, never fails: an unreadable or mis-shaped file (or
entry) warns once and behaves as empty, so a corrupt cache can only
cost re-tuning — it can never take the kernels down.  Transient read
errors (OSError family) are retried with jittered backoff via
``resilience.retry_transient`` before the degradation kicks in.

Location: ``$REPRO_PLAN_CACHE`` if set (the variable the reference
reads too), else ``~/.cache/repro_torch/tuning_plans.json``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import tempfile
import time
import warnings
from typing import Any, Dict, Optional

CACHE_SCHEMA_VERSION = 2
# older schemas this reader still accepts (entry shape is identical)
_ACCEPTED_SCHEMA_VERSIONS = (1, CACHE_SCHEMA_VERSION)
CACHE_PATH_ENV = "REPRO_PLAN_CACHE"
DEFAULT_CACHE_PATH = "~/.cache/repro_torch/tuning_plans.json"

# hw_fingerprint fields that identify the execution environment for
# plan reuse (the paper-config digest is model-level, not kernel-level)
_ENV_KEYS = ("python", "platform", "machine", "torch", "numpy", "cuda",
             "gpu", "capability", "power_limit_w")

# the process's fingerprint and its digest, read once: the wrappers key
# every lookup on it, and reading the power limit starts nvidia-smi
_env: Dict[str, Any] = {}


def env_fingerprint() -> Dict[str, Any]:
    """The plan-relevant slice of ``obs.report.hw_fingerprint()``
    (read once per process; ``forget_env`` reads it again)."""
    if "fp" not in _env:
        from repro_torch.obs.report import hw_fingerprint
        fp = hw_fingerprint()
        _env["fp"] = {k: fp.get(k) for k in _ENV_KEYS}
    return dict(_env["fp"])


def forget_env() -> None:
    """Drop the fingerprint read so far (tests: after patching it)."""
    _env.clear()


def env_sig(fp: Optional[Dict[str, Any]] = None) -> str:
    if fp is None:
        if "sig" not in _env:
            _env["sig"] = env_sig(env_fingerprint())
        return _env["sig"]
    blob = json.dumps({k: fp.get(k) for k in _ENV_KEYS}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def cache_key(kernel: str, problem) -> str:
    return f"{kernel}|{problem.sig}|{env_sig()}"


def _valid_entry(entry: Any) -> bool:
    return (isinstance(entry, dict)
            and isinstance(entry.get("plan"), dict)
            and all(isinstance(k, str) and isinstance(v, int)
                    and not isinstance(v, bool)
                    for k, v in entry["plan"].items()))


class PlanCache:
    """Load-once, save-atomically plan store with hit/miss counters."""

    def __init__(self, path: Optional[str] = None):
        raw = path or os.environ.get(CACHE_PATH_ENV) \
            or DEFAULT_CACHE_PATH
        self.path = pathlib.Path(raw).expanduser()
        self.hits = 0
        self.misses = 0
        # fault seam: called as hook("read_cache", path) before the
        # read; an OSError here is absorbed by retry_transient
        self.fault_hook = None
        self._plans: Optional[Dict[str, Dict[str, Any]]] = None

    # ------------------------------------------------------------- load

    def _read_text(self) -> str:
        from repro_torch.resilience.retry import retry_transient

        def attempt():
            if self.fault_hook is not None:
                self.fault_hook("read_cache", self.path)
            return self.path.read_text(encoding="utf-8")

        return retry_transient(attempt, attempts=3, base_delay=0.005)

    def _load(self) -> Dict[str, Dict[str, Any]]:
        if self._plans is not None:
            return self._plans
        self._plans = {}
        if self.path.exists():
            try:
                doc = json.loads(self._read_text())
                if (not isinstance(doc, dict)
                        or doc.get("schema_version")
                        not in _ACCEPTED_SCHEMA_VERSIONS
                        or not isinstance(doc.get("plans"), dict)):
                    raise ValueError("unrecognized plan-cache schema")
                self._plans = dict(doc["plans"])
            except (ValueError, OSError, RuntimeError) as e:
                # RuntimeError: resilience.RetriesExhausted — the
                # transient-I/O retries gave up; still degrade, never
                # take the kernels down
                warnings.warn(
                    f"plan cache {self.path} unreadable ({e}); "
                    "ignoring it and falling back to default plans",
                    RuntimeWarning, stacklevel=3)
        return self._plans

    # ----------------------------------------------------------- access

    def get(self, key: str) -> Optional[Dict[str, int]]:
        """The cached plan for ``key``, or None.  Mis-shaped entries
        warn and count as misses."""
        entry = self._load().get(key)
        if entry is not None and not _valid_entry(entry):
            warnings.warn(
                f"plan cache {self.path}: entry {key!r} is mis-shaped; "
                "ignoring it", RuntimeWarning, stacklevel=3)
            entry = None
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        return dict(entry["plan"])

    def entry(self, key: str) -> Optional[Dict[str, Any]]:
        """Full cache record (plan + provenance), if valid."""
        entry = self._load().get(key)
        return dict(entry) if _valid_entry(entry) else None

    def put(self, key: str, plan: Dict[str, int],
            **meta: Any) -> None:
        self._load()[key] = {
            "plan": {k: int(v) for k, v in plan.items()},
            "tuned_at": time.time(),
            "env": env_fingerprint(),
            **meta,
        }

    def __len__(self) -> int:
        return len(self._load())

    # ------------------------------------------------------------- save

    def save(self) -> pathlib.Path:
        """Atomic write (tmp + rename): a crashed tuner never leaves a
        half-written cache behind."""
        doc = {"schema_version": CACHE_SCHEMA_VERSION,
               "plans": self._load()}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name + ".")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return self.path
