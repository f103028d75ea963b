"""Each reference family computes the port's model: at a small size in
fp32 on the CPU, the plain reference's logits equal those of the
port's ``lm.prefill`` and of ``lm.decode_step`` through the cache, image
positions included; and the reference is no copy of the port: it
imports nothing of it."""
from __future__ import annotations

import ast
import importlib

import pytest
import torch

from conftest import ROOT, tiny_cell
from portbench import harness, program
from portbench.weights import Weights

P, G, B = 12, 6, 2


def port_and_reference(family, seed=7):
    from repro_torch.models import lm
    cell = tiny_cell(family)
    ctx = harness.context(cell, seed, torch.device("cpu"))
    cfg = program.program_config(family, ctx.dims)
    w = Weights(ctx.reference.layout(ctx.dims), torch.device("cpu"))
    w.draw(seed)
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, ctx.dims["vocab"], (B, P), generator=g)
    batch = {"tokens": tokens}
    image = None
    if family == "vlm":
        image = torch.randn((B, 4, ctx.dims["d"]), generator=g)
        batch["patch_embeds"] = image
    opts = program.serve_options(cfg, ctx.config["port_arch"], B, P, G)
    logits, cache = lm.prefill(cfg, w.tree, batch, opts)
    got, served = [logits], []
    for i in range(G - 1):
        # a token off the argmax, so the check does not lean on greedy
        tok = torch.randint(0, ctx.dims["vocab"], (B,), generator=g)
        served.append(tok)
        got.append(lm.decode_step(cfg, w.tree, cache, tok, P + i, opts)[0])
    got = torch.stack(got, 1)
    seqs = torch.cat([tokens, torch.stack(served, 1)], 1)
    want = ctx.reference.logits(ctx.dims, w.tree, seqs,
                                range(P - 1, P + G - 1), image)
    return got, want, ctx, w, seqs, image


def test_reference_equals_the_port_through_prefill_and_decode(family):
    got, want, *_ = port_and_reference(family)
    assert got.shape == want.shape == (B, G, 256)
    err = (got - want).abs().max() / want.abs().max()
    # fp32 on both sides, sums in other orders
    assert err < 1e-4, err


def test_image_positions_reach_the_logits():
    got, want, ctx, w, seqs, image = port_and_reference("vlm")
    plain = ctx.reference.logits(ctx.dims, w.tree, seqs,
                                 range(P - 1, P + G - 1), None)
    assert (plain - want).abs().max() > 1e-2 * want.abs().max()


def test_control_rounds_far_more_than_the_port():
    got, want, ctx, w, seqs, image = port_and_reference("rwkv")
    low = ctx.reference.logits(ctx.dims, w.tree, seqs,
                               range(P - 1, P + G - 1), image, "fp8")
    assert (low - want).abs().max() > 100 * (got - want).abs().max()


@pytest.mark.parametrize("name", ["vlm", "rwkv", "common"])
def test_reference_imports_nothing_of_the_program(name):
    path = ROOT / "portbench" / "reference" / f"{name}.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"__future__", "math", "functools", "typing", "torch",
                    "portbench"}, tops
    mod = importlib.import_module(f"portbench.reference.{name}")
    for value in vars(mod).values():
        origin = getattr(value, "__module__", "") or ""
        assert not origin.split(".")[0].startswith("repro"), value
