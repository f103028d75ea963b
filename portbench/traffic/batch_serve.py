"""Traffic kind ``batch_serve``: a closed loop of static batches, the
port's serving mode, driven through ``launch.serve.compile_step_fns``
(the CUDA graphs over ``lm.prefill`` and ``lm.decode_step``).

A cell's file (``workloads/<cell>.json``) gives ``batch`` requests that
arrive together, each with ``prompt_len`` prompt tokens (the first
``image_positions`` of them embedded by patch embeddings) and ``gen``
output tokens, and how many finished requests the check compares.  Each
batch's tokens and patch embeddings are drawn on the device from the
run's seed and the batch's index, so every seed sends the same sizes.

One batch: the prompt is copied into the prefill graph and replayed,
the first token is the argmax of its fp32 logits, then the decode graph
is replayed ``gen - 1`` times, each step token in, replay, argmax, the
token stored, ``synchronize()``, on the host clock.  The window serves
whole batches back to back and closes at the end of the first batch
that ends ``--seconds`` or more after its start: every batch of it is
finished, and a rate is all its tokens over all its time, which moves
smoothly with the batch's time and not in steps of a batch.

The check: once the window has closed, a sample of the finished
requests drawn from the seed, each prompt with its served tokens, goes
through the family's plain fp32 reference; the number compared is the
widest gap by which a served token's reference logit lies below the
reference's best at that position.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from portbench import program, trace
from portbench.weights import Weights, generator


def batch_inputs(ctx, k: int) -> Dict[str, torch.Tensor]:
    """Batch ``k``'s prompt tokens [B, P] (and patch embeddings
    [B, I, d] in the model's dtype), drawn on the device from the seed."""
    w = ctx.workload
    B, P, I = w["batch"], w["prompt_len"], w.get("image_positions", 0)
    g = generator(ctx.device, ctx.seed, "batch", k)
    tokens = torch.randint(0, ctx.dims["vocab"], (B, P), generator=g,
                           device=ctx.device)
    out = {"tokens": tokens}
    if I:
        out["patch_embeds"] = torch.randn(
            (B, I, ctx.dims["d"]), generator=g, device=ctx.device,
            dtype=ctx.weights.buffers[ctx.dims["dtype"]].dtype)
    return out


# untimed serving at the end of set-up, in seconds of the host clock
WARMUP_S = 30.0


def prepare(ctx) -> None:
    """Set-up: kernels, weights from the seed, the two graphs captured,
    then untimed batches until ``WARMUP_S`` have passed (one at least).
    On the card a decode step first runs ~0.85 ms slower, until it drops
    once, after 5 s to over 30 s of serving (not the launch, not a clock;
    the cause is not known); the warm-up keeps most of that out of the
    window.  Each warm-up batch's median step is kept for standard error
    (``ctx.warmup``), where a run shows when it dropped."""
    from repro_torch.launch import serve
    w = ctx.workload
    B, P, G = w["batch"], w["prompt_len"], w["gen"]
    cfg = program.program_config(ctx.config["family"], ctx.dims)
    program.check_layout(cfg, ctx.reference.layout(ctx.dims))
    if ctx.device.type == "cuda":
        program.build_kernels()
    ctx.weights = Weights(ctx.reference.layout(ctx.dims), ctx.device)
    ctx.weights.draw(ctx.seed)
    opts = program.serve_options(cfg, ctx.config["port_arch"], B, P, G)
    with torch.no_grad():
        prefill_fn, step = serve.compile_step_fns(
            cfg, ctx.weights.tree, batch_inputs(ctx, -1), opts, P)
    ctx.state = {"prefill_fn": prefill_fn, "step": step}
    ctx.warmup = []
    t0 = time.perf_counter()
    while not ctx.warmup or time.perf_counter() - t0 < WARMUP_S:
        rec = serve_batch(ctx, -1 - len(ctx.warmup), None)
        ctx.warmup.append(median_ms(rec["steps"]))
    sync(ctx)


def median_ms(seconds: List[float]) -> float:
    from portbench.stats import percentile
    return percentile(seconds, 50) * 1e3 if seconds else float("nan")


def sync(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def serve_batch(ctx, k: int, tracer) -> dict:
    """Serve batch ``k`` whole.  Returns its record: start, end, time to
    first token, each decode step's host seconds, the host seconds spent
    inside its ``step()`` call (the graph's launch) and its position,
    the tokens served [B, G]."""
    w = ctx.workload
    B, P, G = w["batch"], w["prompt_len"], w["gen"]
    V = ctx.dims["vocab"]
    prefill_fn, step = ctx.state["prefill_fn"], ctx.state["step"]
    with trace.span(tracer, "inputs"):
        inp = batch_inputs(ctx, k)
        out = torch.empty((B, G), dtype=torch.long, device=ctx.device)
        sync(ctx)
    rec = {"index": k, "steps": [], "launch": [], "positions": [],
           "out": out}
    with torch.no_grad():
        t0 = time.perf_counter()
        with trace.span(tracer, "prefill"):
            logits, _ = prefill_fn(inp)
        with trace.span(tracer, "first_token"):
            tok = torch.argmax(logits[:, :V], dim=-1)
            out[:, 0] = tok
            sync(ctx)
        t1 = time.perf_counter()
        rec["start"], rec["ttft"] = t0, t1 - t0
        for i in range(1, G):
            ta = time.perf_counter()
            with trace.span(tracer, "decode"):
                logits = step(tok, P + i - 1)
            tb = time.perf_counter()
            with trace.span(tracer, "next_token"):
                tok = torch.argmax(logits[:, :V], dim=-1)
                out[:, i] = tok
                sync(ctx)
            t1 = time.perf_counter()
            rec["steps"].append(t1 - ta)
            rec["launch"].append(tb - ta)
            rec["positions"].append(P + i - 1)
    rec["end"] = t1
    rec["tokens"] = B * G
    return rec


def window(ctx, seconds: float, tracer) -> dict:
    """The measured window: whole batches back to back until one ends
    ``seconds`` or more after the start; its length is the time to that
    batch's end.  With a tracer, one more batch is served under the
    profiler once the window has closed: on the card a graph's launch
    stays ~9 times slower once the profiler has run, so no step of the
    window follows it."""
    batches: List[dict] = []
    t_start = time.perf_counter()
    while not batches or batches[-1]["end"] - t_start < seconds:
        batches.append(serve_batch(ctx, len(batches), None))
    record = {"start": t_start, "end": batches[-1]["end"],
              "seconds": batches[-1]["end"] - t_start, "batches": batches,
              "tokens": sum(b["tokens"] for b in batches),
              "attempted": ctx.workload["batch"] * len(batches),
              "warmup": ctx.warmup}
    if tracer is not None:
        tracer.warm()
        tracer.start()
        serve_batch(ctx, len(batches), tracer)
        tracer.stop()
    return record


def describe(record: dict) -> List[str]:
    """Lines for standard error: the window's batches and the warm-up's
    median steps, the window's decode steps by quantile and their mean
    launch, each batch's median step, and the steps by their place in a
    batch (the first eight after a prefill, the rest), in ms."""
    from portbench.stats import percentile
    steps = [s for b in record["batches"] for s in b["steps"]]
    if not steps:
        return ["decode steps: none in the window"]
    q = {p: percentile(steps, p) * 1e3 for p in (5, 50, 90, 95, 99)}
    first = [s for b in record["batches"] for s in b["steps"][:8]]
    rest = [s for b in record["batches"] for s in b["steps"][8:]]
    launch = [s for b in record["batches"] for s in b["launch"]]
    lines = [f"window: {len(record['batches'])} batches in "
             f"{record['seconds']:.4f} s; warm-up batch medians (ms): "
             + " ".join(f"{m:.3f}" for m in record["warmup"]),
             f"decode steps: {len(steps)}; ms at p5 {q[5]:.4f} p50 "
             f"{q[50]:.4f} p90 {q[90]:.4f} p95 {q[95]:.4f} p99 {q[99]:.4f} "
             f"max {max(steps) * 1e3:.4f}; launch mean "
             f"{sum(launch) / len(launch) * 1e3:.4f}",
             "batch medians (ms): " + " ".join(
                 f"{median_ms(b['steps']):.3f}"
                 for b in record["batches"] if b["steps"]),
             f"first 8 steps of a batch: mean "
             f"{sum(first) / len(first) * 1e3:.4f} ms"]
    if rest:
        lines[-1] += f"; the rest {sum(rest) / len(rest) * 1e3:.4f} ms"
    return lines


def release(ctx) -> None:
    """Free the program's state (graphs, their pools, caches): what is
    left on the device is the benchmark's weights and tokens."""
    ctx.state = None
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()


def sample(ctx, record: dict) -> List[tuple]:
    """(batch index, row) of the finished requests the check compares,
    drawn from the seed."""
    done = [(b["index"], r) for b in record["batches"]
            for r in range(ctx.workload["batch"])]
    n = min(ctx.workload["check"]["requests"], len(done))
    return sorted(random.Random(f"{ctx.seed}:check").sample(done, n))


def request_tokens(ctx, record: dict, chosen: List[tuple]):
    """For each chosen request: its prompt with its served tokens but the
    last [n, P + G - 1], its served tokens [n, G], and its patch
    embeddings [n, I, d] or None."""
    by_index = {b["index"]: b for b in record["batches"]}
    seqs, served, image = [], [], []
    for k in sorted({k for k, _ in chosen}):
        inp = batch_inputs(ctx, k)
        rows = [r for kk, r in chosen if kk == k]
        out = by_index[k]["out"][rows]
        served.append(out)
        seqs.append(torch.cat([inp["tokens"][rows], out[:, :-1]], dim=1))
        if "patch_embeds" in inp:
            image.append(inp["patch_embeds"][rows])
    return (torch.cat(seqs), torch.cat(served),
            torch.cat(image) if image else None)


def reference_logits(ctx, seqs, image, precision: str = "fp32"):
    """The reference's fp32 logits at the positions that predict each
    served token, computed ``check["block"]`` requests at a time."""
    w = ctx.workload
    P, G = w["prompt_len"], w["gen"]
    block = w["check"].get("block", seqs.shape[0])
    parts = []
    for a in range(0, seqs.shape[0], block):
        parts.append(ctx.reference.logits(
            ctx.dims, ctx.weights.tree, seqs[a:a + block],
            range(P - 1, P + G - 1),
            image[a:a + block] if image is not None else None, precision))
    return torch.cat(parts)


def widest_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """max over positions of (the reference's best logit - its logit of
    ``tokens`` there); NaN anywhere reads as NaN."""
    got = ref.gather(-1, tokens[..., None])[..., 0]
    gap = ref.max(dim=-1).values - got
    if not torch.isfinite(gap).all():
        return float("nan")
    return float(gap.max())


def check(ctx, record: dict) -> Dict[str, tuple]:
    """{name: (value, limit)} of the numbers compared."""
    chosen = sample(ctx, record)
    seqs, served, image = request_tokens(ctx, record, chosen)
    ref = reference_logits(ctx, seqs, image)
    limit = ctx.workload["check"]["logit_gap_limit"]
    return {"logit_gap": (widest_gap(ref, served), limit)}


def readings(ctx, record: dict, control: bool = True) -> dict:
    """The check's number and, with ``control``, the control's on the
    same sample: the reference in float8, whose own first choice at each
    position is read under the fp32 reference."""
    chosen = sample(ctx, record)
    seqs, served, image = request_tokens(ctx, record, chosen)
    ref = reference_logits(ctx, seqs, image)
    out = {"requests": len(chosen), "tokens": served.numel(),
           "logit_gap": widest_gap(ref, served)}
    if control:
        low = reference_logits(ctx, seqs, image, precision="fp8")
        out["control_fp8_gap"] = widest_gap(ref, low.argmax(-1))
    return out
