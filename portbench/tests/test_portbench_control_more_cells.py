"""The control of every cell of ``BENCHMARK.json`` that
``test_portbench_control.py`` does not list, on the card at the cell's
own sizes: the plain reference in float8 put in the program's place must
fail the cell's committed limit, on three seeds, while the program on
the same seeds passes it.

    python -m pytest portbench/tests/test_portbench_control_more_cells.py -m gpu

(zamba2-7b-instruct.chat about three minutes on an H100: a batch of 32
takes 23 s, the check's fp32 and float8 references 10 s a seed;
pixtral-12b.long-doc about one).  Each window serves one whole batch,
which holds the check's requests."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT
from portbench import harness
from test_portbench_control import CELLS as LISTED, SEEDS

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = sorted(w["name"] for w in SPEC["workloads"]
               if w["name"] not in LISTED)
# seconds of each window: the first batch that ends past it ends it
WINDOW_S = 1


def test_every_cell_has_a_control():
    assert "zamba2-7b-instruct.chat" in CELLS
    assert "pixtral-12b.long-doc" in CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit_the_program_keeps(name, card):
    cell = harness.load_cell(ROOT, name)
    ctx = harness.context(cell, SEEDS[0], card)
    ctx.kind.prepare(ctx)
    limit = cell.workload["check"]["logit_gap_limit"]
    for seed in SEEDS:
        ctx.seed = seed
        ctx.weights.draw(seed)
        record = ctx.kind.window(ctx, WINDOW_S, None)
        got = ctx.kind.readings(ctx, record)
        print(json.dumps({"workload": name, "seed": seed, "limit": limit,
                          **got}), flush=True)
        assert got["requests"] == cell.workload["check"]["requests"]
        assert got["logit_gap"] <= limit < got["control_fp8_gap"], got
    ctx.kind.release(ctx)
    del ctx
    torch.cuda.empty_cache()
