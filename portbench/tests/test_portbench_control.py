"""The control of each cell, on the card at the cell's own sizes: the
plain reference in float8 (the precision below the configurations'
bf16) put in the program's place must fail the cell's limit, on three
seeds, while the program on the same seeds passes it.

    python -m pytest portbench/tests/test_portbench_control.py -m gpu

(a few minutes for the two cells on an H100; a cell maps to the seconds
of its window, which serves whole batches: enough for the requests its
check compares)."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT
from portbench import harness

CELLS = {"pixtral-12b.image-chat": 1, "rwkv6-1.6b.long-doc": 2}
SEEDS = (2**32 + 11, 2**32 + 12, 2**32 + 13)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_the_limit_the_program_keeps(name, card):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert any(w["name"] == name for w in spec["workloads"])
    cell = harness.load_cell(ROOT, name)
    ctx = harness.context(cell, SEEDS[0], card)
    ctx.kind.prepare(ctx)
    limit = cell.workload["check"]["logit_gap_limit"]
    for seed in SEEDS:
        ctx.seed = seed
        ctx.weights.draw(seed)
        record = ctx.kind.window(ctx, CELLS[name], None)
        got = ctx.kind.readings(ctx, record)
        assert got["requests"] == cell.workload["check"]["requests"]
        assert got["logit_gap"] <= limit < got["control_fp8_gap"], got
    ctx.kind.release(ctx)
    del ctx
    torch.cuda.empty_cache()
