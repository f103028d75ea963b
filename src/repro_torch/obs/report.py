"""Structured benchmark report (the ``--json`` sink of benchmarks/run.py).

Replaces grep-the-CSV archaeology with a schema-versioned document so
the BENCH trajectory is machine-readable: per-benchmark ``us_per_call``
and the same ``derived`` payload the CSV carries, plus optional
``jitter`` blocks (the Fig. 4 fluctuation metrics) and a hardware/
software fingerprint so numbers from different environments are never
compared blindly.

``validate_report`` is a hand-rolled structural check (no jsonschema
dependency); it returns a list of error strings — empty means valid —
and is what tests and future tooling call before trusting a report.

A copy of the reference's ``obs/report.py``: the same schema (v1), so
each package's ``validate_report`` accepts the other's documents
(``tests/test_torch_obs.py``), with the port's fingerprint.
"""
from __future__ import annotations

import hashlib
import platform
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs.multivic_paper import PAPER_CONFIGS

BENCH_SCHEMA_VERSION = 1

# jitter blocks mirror obs.jitter.JitterStats.as_dict()
_JITTER_KEYS = ("n", "mean", "median", "std", "min", "max", "spread",
                "p99", "cov", "wcet_margin")


def hw_fingerprint() -> Dict[str, Any]:
    """Environment identity attached to every report.

    The reference's keys but ``jax``/``backend``: in their place the
    torch version and the card (``compat.device_identity``: CUDA
    version, device name, capability, power limit), all ``None`` but
    ``torch`` without a card.  ``paper_configs_sha256`` is taken from
    the port's own copy of the paper's configurations and equals the
    reference's."""
    cfg_digest = hashlib.sha256(
        "|".join(repr(c) for c in PAPER_CONFIGS).encode()).hexdigest()
    return {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "machine": platform.machine(),
        "torch": torch.__version__,
        **compat.device_identity(),
        "numpy": np.__version__,
        "paper_configs_sha256": cfg_digest,
    }


def make_report(rows: Sequence[Dict[str, Any]], *,
                fast: bool = False,
                generated_at: Optional[float] = None) -> Dict[str, Any]:
    """Build the schema-v1 document from benchmark rows.

    Rows are the same dicts the CSV printer consumes
    (``name`` / ``us_per_call`` / ``derived``); an optional ``jitter``
    key (a ``JitterStats.as_dict()``) rides along untouched.
    ``generated_by`` names the port (the reference's names its writer,
    ``benchmarks.run``).
    """
    benchmarks = []
    for r in rows:
        entry: Dict[str, Any] = {
            "name": str(r["name"]),
            "us_per_call": float(r["us_per_call"]),
            "derived": str(r["derived"]),
        }
        if r.get("jitter") is not None:
            entry["jitter"] = dict(r["jitter"])
        benchmarks.append(entry)
    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "generated_by": "repro_torch",
        "generated_at": float(time.time() if generated_at is None
                              else generated_at),
        "fast": bool(fast),
        "hw_fingerprint": hw_fingerprint(),
        "benchmarks": benchmarks,
    }


def validate_report(doc: Any) -> List[str]:
    """Structural validation; returns error strings (empty = valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"report must be an object, got {type(doc).__name__}"]
    if doc.get("schema_version") != BENCH_SCHEMA_VERSION:
        errs.append(f"schema_version must be {BENCH_SCHEMA_VERSION}, "
                    f"got {doc.get('schema_version')!r}")
    for key, typ in (("generated_by", str), ("generated_at", float),
                     ("fast", bool), ("hw_fingerprint", dict),
                     ("benchmarks", list)):
        if not isinstance(doc.get(key), typ):
            errs.append(f"missing or mistyped field {key!r} "
                        f"(want {typ.__name__})")
    fp = doc.get("hw_fingerprint")
    if isinstance(fp, dict):
        for key in ("python", "platform", "numpy",
                    "paper_configs_sha256"):
            if key not in fp:
                errs.append(f"hw_fingerprint missing {key!r}")
    for i, b in enumerate(doc.get("benchmarks") or []):
        where = f"benchmarks[{i}]"
        if not isinstance(b, dict):
            errs.append(f"{where} must be an object")
            continue
        if not isinstance(b.get("name"), str) or not b.get("name"):
            errs.append(f"{where}.name must be a non-empty string")
        if not isinstance(b.get("us_per_call"), (int, float)):
            errs.append(f"{where}.us_per_call must be a number")
        if not isinstance(b.get("derived"), str):
            errs.append(f"{where}.derived must be a string")
        if "jitter" in b:
            j = b["jitter"]
            if not isinstance(j, dict):
                errs.append(f"{where}.jitter must be an object")
                continue
            for key in _JITTER_KEYS:
                if key not in j:
                    errs.append(f"{where}.jitter missing {key!r}")
                elif key != "wcet_margin" and not isinstance(
                        j[key], (int, float)):
                    errs.append(f"{where}.jitter.{key} must be a number")
    return errs
