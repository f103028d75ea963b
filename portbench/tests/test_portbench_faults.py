"""The check against the plain reference fails a broken timed path.

Each test drives the rest of a run (set-up, window, check) on the CPU at
a small size in fp32, past the look for a card, with the program broken
underneath where it produces its state or its tokens; ``correct`` must
come out false.  The sound run beside them comes out true.  (A cell on
one card has no exchange between cards to leave out.)"""
from __future__ import annotations

import time

import torch

from conftest import tiny_cell
from portbench import harness

SEED = 2**33 + 5


def run(family):
    # a window of 0 s serves one batch, so the check compares each of its
    # requests, the rows that a fault spares among them
    return harness.execute(tiny_cell(family), SEED, 0.0, False,
                           torch.device("cpu"), time.perf_counter())


def test_sound_run_is_correct(family):
    res = run(family)
    assert res["correct"], res["compared"]
    assert res["compared"]["logit_gap"]["value"] <= 1e-4
    assert res["metrics"]["tok_s"]["value"] > 0
    assert set(res["metrics"]) == {"tok_s", "ttft_ms", "itl_p95_ms",
                                   "setup_s"}


def test_step_that_returns_its_state_unchanged(family, monkeypatch):
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_map
    real = lm.decode_step

    def frozen(cfg, params, cache, token, pos, opts=lm.DEFAULT_OPTS):
        scratch = tree_map(torch.clone, cache)
        return real(cfg, params, scratch, token, pos, opts)[0], cache

    monkeypatch.setattr(lm, "decode_step", frozen)
    res = run(family)
    assert not res["correct"], res["compared"]


def test_half_of_the_batch_left_out(family, monkeypatch):
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_map
    real = lm.prefill

    def half(cfg, params, batch, opts=lm.DEFAULT_OPTS):
        n = batch["tokens"].shape[0] // 2
        logits, cache = real(cfg, params, {k: v[:n] for k, v in
                                           batch.items()}, opts)
        # the rest of the batch is served the first half's answers
        return (torch.cat([logits, logits]),
                tree_map(lambda c: torch.cat([c, c], dim=1), cache))

    monkeypatch.setattr(lm, "prefill", half)
    res = run(family)
    assert not res["correct"], res["compared"]


def test_token_altered_where_it_is_produced(family, monkeypatch):
    from repro_torch.models import lm
    real = lm.decode_step
    prompt = tiny_cell(family).workload["prompt_len"]

    def altered(cfg, params, cache, token, pos, opts=lm.DEFAULT_OPTS):
        logits, cache = real(cfg, params, cache, token, pos, opts)
        if int(pos) == prompt + 1:
            wrong = (logits[0].argmax() + 1) % cfg.vocab_size
            logits = logits.clone()
            logits[0, wrong] = logits[0].max() + 1.0
        return logits, cache

    monkeypatch.setattr(lm, "decode_step", altered)
    res = run(family)
    assert not res["correct"], res["compared"]
    # it is the limit that decides: the same fault under no limit passes
    cell = tiny_cell(family)
    cell.workload["check"]["logit_gap_limit"] = 1e9
    assert harness.execute(cell, SEED, 0.0, False, torch.device("cpu"),
                           time.perf_counter())["correct"]
