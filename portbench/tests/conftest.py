"""Fixtures of the benchmark's tests: cells of each family at a size the
CPU runs in seconds, and the repository on ``sys.path``.

    python -m pytest portbench/tests -q

Tests marked ``gpu`` decide inside the test whether a card is there."""
from __future__ import annotations

import copy
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
# the serving plan's defaults, as the benchmark runs it: no tuned plan
os.environ.setdefault("REPRO_AUTOTUNE", "0")
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "vlm": {"name": "tiny-vlm", "family": "vlm", "port_arch": "pixtral-12b",
            "dtype": "float32", "num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
            "rope_theta": 1e9, "rms_norm_eps": 1e-6},
    "rwkv": {"name": "tiny-rwkv", "family": "rwkv", "port_arch": "rwkv6-1.6b",
             "dtype": "float32", "n_layer": 2, "n_embd": 64,
             "head_size_a": 16, "dim_ffn": 128, "vocab_size": 256,
             "time_mix_extra_dim": 8, "time_decay_extra_dim": 8,
             "norm_eps": 1e-6, "group_norm_eps": 0.00064},
}
TINY_TRAFFIC = {"traffic": "tiny", "kind": "batch_serve", "batch": 2,
                "prompt_len": 12, "gen": 5,
                "check": {"requests": 4, "block": 2,
                          "logit_gap_limit": 1e-3}}
# at the tiny size one untimed batch warms up enough
TINY_WARMUP_S = 0.0


def tiny_cell(family: str, dtype: str = "float32", **traffic):
    """A cell of ``family`` at the tiny size, with the real metric list
    of ``BENCHMARK.json`` applied to it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny"] if (
                family == "vlm" or m["name"] != "flash_attention_roofline"
            ) and (family == "rwkv" or m["name"] != "wkv6_roofline") else []
    config = dict(TINY_CONFIGS[family], dtype=dtype)
    workload = copy.deepcopy(TINY_TRAFFIC)
    if family == "vlm":
        workload["image_positions"] = 4
    workload.update(traffic)
    entry = {"name": "tiny", "config": config["name"], "traffic": "tiny",
             "chips": 1}
    return SimpleNamespace(spec=spec, entry=entry, config=config,
                           workload=workload)


@pytest.fixture(autouse=True)
def tiny_warmup(monkeypatch):
    from portbench.traffic import batch_serve
    monkeypatch.setattr(batch_serve, "WARMUP_S", TINY_WARMUP_S)


@pytest.fixture(params=["vlm", "rwkv"])
def family(request):
    return request.param


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
