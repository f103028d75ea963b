"""Batched serving driver of the port, with the MultiVic-style static
step bound (port of the reference's ``launch/serve.py``).

Each decode step runs the same program, so the driver prints the H100
WCET bound per step (``core.gpu_mapping``) next to the measured step
times and their jitter.  The step program follows a serving plan
(``tuning.model.resolve_model_plan``: explicit ``--chunk-q``/
``--chunk-kv`` over a tuned plan cached for this configuration and
card, over the defaults; the banner and ``main``'s ``plan_source`` say
which), and the WCET bound and the step deadline are built from that
same plan.  The bound becomes a deadline
(``wcet * --deadline-slack`` or ``--deadline-ms``); overruns walk the
record -> warn -> shed ladder (``resilience.DeadlineMonitor``), and a
shed halves the batch.

On CUDA the weight-pass products run the hand-written ``spm_matmul``
kernel, prefill attention (zamba2's tied blocks', whisper's unmasked
encoder and cross-attention too) the hand-written ``flash_attention``
kernel and an RWKV model's prefill WKV the hand-written ``wkv6``
kernel; an MoE layer's expert products are batched einsums and
zamba2's SSD scan is torch ops, as in the reference.  An
encoder-decoder model (whisper) is fed random ``frames`` of the
prompt's length, as the reference's serve feeds them: its encoder
memory is as long as the prompt.
Before anything is timed, the kernels are built and
``compile_step_fns`` (the counterpart of the reference's AOT
compilation) captures one prefill and one decode step as CUDA graphs:
the prefill on a static token buffer of the served (batch, prompt
length), whose outputs (the fp32 last-token logits and the whole
cache: KV, RWKV or Mamba2 state) are the graph's static buffers, and the decode
step over that same cache, which it updates in place.  The timed
prefill is one replay, and each decode step one replay (the decode
graph is captured again after a shed; prefill is not re-run).  Eager,
the host's launches, not the card, would set both times.  If capture
fails, serve raises: nothing timed runs eagerly on the card.  A replay
relaunches the captured kernels without passing through their
wrappers, so the wrappers' launch counters count each captured launch
once; ``main`` reports the launches its replays made (captured per
replay x replays) beside them.  Prefill and steps are timed on the
host clock around work that ends in ``torch.cuda.synchronize()``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --full --batch 4 --prompt-len 256 --gen 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --full --batch 4 --prompt-len 256 --gen 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --full --batch 4 --prompt-len 2048 --gen 32         # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --full --batch 4 --prompt-len 512 --gen 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --full --batch 4 --prompt-len 1536 --gen 32         # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \\
      --full --batch 4 --prompt-len 1024 --gen 32         # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-235b-a22b --dtype float32          # reduced MoE
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Set ``REPRO_TRACE=/path/serve.json`` to record the prefill and every
decode step as spans on the ``serve`` track (plus a per-step latency
counter and the ``deadline_*`` instants) and dump a Chrome trace at
exit, as the reference's serve does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.gpu_mapping import serve_step_wcet
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.spm_matmul import ops as mm_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import RunOptions
from repro_torch.models.spec import tree_map
from repro_torch.obs import TraceRecorder, jitter_stats, write_chrome_trace
from repro_torch.resilience.deadline import DeadlineMonitor
from repro_torch.tuning.model import (ModelProblem, plan_sig,
                                      resolve_model_plan)


def reduced_config(cfg, args):
    """CLI shim over configs.reduce_config (the reference's
    ``launch/train.py::reduced_config``)."""
    return reduce_config(cfg, layers=args.layers, d_model=args.d_model,
                         vocab=args.vocab)


def shed_batch(cfg, cache, tok, n_new: int, cache_len: int,
               windowed: bool = False):
    """Drop the tail of the batch (graceful degradation).

    ``lm.cache_spec`` names the logical axes of every cache leaf, so
    exactly the axis labelled ``batch`` is sliced (index 1 behind the
    ``stack`` axis) and nothing else.  The slices are views of the
    preallocated buffers, so later in-place decode writes still land
    in them."""
    b_old = tok.shape[0]
    if not 0 < n_new < b_old:
        raise ValueError(f"shed to {n_new} from a batch of {b_old}")
    spec = lm_mod.cache_spec(cfg, b_old, cache_len, windowed)

    def shed(c, par):
        if "batch" not in par.axes:
            return c
        return c.narrow(par.axes.index("batch"), 0, n_new)

    return tree_map(shed, cache, spec), tok[:n_new]


def plan_wcet_s(cfg, plan: dict, batch: int, n_params: int) -> float:
    """The per-step WCET bound for the decode weight pass under the
    served plan's tile pins: the one source of both the printed bound
    and the derived deadline."""
    return serve_step_wcet(batch, cfg.d_model, n_params, plan=plan)


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    return {"spm_matmul": mm_ops.matmul.launches,
            "flash_attention": fa_ops.attention.launches,
            "wkv6": wkv_ops.wkv.launches}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_stepper(cfg, params, cache, tok, pos: int, opts: RunOptions):
    """``step(tok, pos) -> logits`` for the decode loop over ``cache``.

    On the CPU it calls ``lm.decode_step``.  On CUDA it captures one
    decode step as a CUDA graph on static token and position buffers
    (the cache's buffers are baked in) and replays it.  The warm-up
    that capture needs writes the K/V of ``tok`` at ``pos``, which the
    first real step writes again.  ``step.captured`` holds the kernel
    launches one replay makes, ``step.replays`` the replays so far."""
    if tok.device.type != "cuda":
        def step(t, p):
            return lm_mod.decode_step(cfg, params, cache, t, p, opts)[0]
        step.captured = dict.fromkeys(launch_counts(), 0)
        step.replays = 0
        return step
    static_tok = tok.clone()
    static_pos = torch.full((), pos, dtype=torch.long, device=tok.device)
    side = torch.cuda.Stream(tok.device)
    side.wait_stream(torch.cuda.current_stream(tok.device))
    with torch.cuda.stream(side):
        lm_mod.decode_step(cfg, params, cache, static_tok, static_pos, opts)
    torch.cuda.current_stream(tok.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        logits, _ = lm_mod.decode_step(cfg, params, cache, static_tok,
                                       static_pos, opts)

    def step(t, p):
        static_tok.copy_(t)
        static_pos.fill_(p)
        graph.replay()
        step.replays += 1
        return logits
    step.captured = {k: n - before[k] for k, n in launch_counts().items()}
    step.replays = 0
    return step


def compile_step_fns(cfg, params, batch: dict, opts: RunOptions,
                     prompt_len: int):
    """``(prefill_fn, step_fn)`` for the shapes of ``batch`` (the
    counterpart of the reference's ``compile_step_fns``).

    ``prefill_fn(batch) -> (logits, cache)`` runs the prompt;
    ``step_fn(tok, pos) -> logits`` runs one decode step over the cache
    the last ``prefill_fn`` call wrote.  On the CPU they are the plain
    ``lm.prefill`` and ``lm.decode_step`` calls.  On CUDA the prefill is
    captured as a CUDA graph on a static copy of ``batch``: its fp32
    logits and cache are the graph's static outputs (they live in its
    memory pool, which ``prefill_fn`` keeps alive), every call copies
    the batch in and replays it, and ``step_fn`` is ``decode_stepper``'s
    graph over that same cache.  As ``decode_stepper`` does, the
    prefill runs once eagerly on a side stream before the capture, so
    each kernel's first launch (function attributes, tensor maps) lands
    outside it.  A failed capture raises.  One untimed prefill and
    decode step run here on both devices, so no first-call cost lands
    in the caller's samples.  ``prefill_fn.captured`` holds the kernel
    launches one replay makes, ``prefill_fn.replays`` the caller's replays
    so far, as ``step_fn``'s do (zeros on the CPU)."""
    dev = batch["tokens"].device
    if dev.type != "cuda":
        held = {}

        def prefill_fn(b):
            logits, held["cache"] = lm_mod.prefill(cfg, params, b, opts)
            return logits, held["cache"]

        def step(t, p):
            return lm_mod.decode_step(cfg, params, held["cache"], t, p,
                                      opts)[0]
        prefill_fn.captured = dict.fromkeys(launch_counts(), 0)
        step.captured = dict.fromkeys(launch_counts(), 0)
        step.replays = prefill_fn.replays = 0
        logits, _ = prefill_fn(batch)
        step(torch.argmax(logits[:, :cfg.vocab_size], dim=-1), prompt_len)
        return prefill_fn, step
    static = {k: v.clone() for k, v in batch.items()}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        lm_mod.prefill(cfg, params, static, opts)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        logits, cache = lm_mod.prefill(cfg, params, static, opts)
    captured = {k: n - before[k] for k, n in launch_counts().items()}
    graph.replay()
    step = decode_stepper(cfg, params, cache,
                          torch.argmax(logits[:, :cfg.vocab_size], dim=-1),
                          prompt_len, opts)

    def prefill_fn(b):
        for k, v in static.items():
            v.copy_(b[k])
        graph.replay()
        prefill_fn.replays += 1
        return logits, cache
    prefill_fn.captured = captured
    prefill_fn.replays = 0
    return prefill_fn, step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--chunk-q", type=int, default=None,
                    help="explicit prefill q-chunk of the plain path "
                         "(overrides the serving plan)")
    ap.add_argument("--chunk-kv", type=int, default=None,
                    help="explicit prefill kv-chunk of the plain path "
                         "(overrides the serving plan)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="explicit per-step deadline; 0 = derive from "
                         "the WCET bound")
    ap.add_argument("--deadline-slack", type=float, default=50.0,
                    help="deadline = WCET bound x slack")
    ap.add_argument("--device", default="cuda",
                    help="cuda (an sm_90 card) or cpu")
    ap.add_argument("--dtype", default=None,
                    help="parameter/activation dtype (default: the "
                         "config's)")
    return ap


def setup(args: argparse.Namespace, dev: torch.device):
    """The model, plan and prompt ``args`` serve on ``dev``: ``(cfg,
    plan, plan_source, opts, params, batch)``.  Weights and prompt are
    drawn from seed 0; an encoder-decoder model's ``frames`` [B, P,
    d_model] (fp32 normals) from the same generator after the tokens,
    as the reference's serve draws them."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg, args)
    if args.dtype:
        compat.torch_dtype(args.dtype)
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    B, P, G = args.batch, args.prompt_len, args.gen

    problem = ModelProblem(
        args.arch, B, P, G, layers=0 if args.full else args.layers,
        d_model=args.d_model, vocab=args.vocab, dtype=cfg.dtype)
    # serving plan: explicit flags > tuned cache entry > defaults
    resolved = resolve_model_plan(cfg, problem, {
        "chunk_q": args.chunk_q, "chunk_kv": args.chunk_kv})
    plan, plan_source = resolved["plan"], resolved["source"]
    opts = RunOptions(chunk_q=int(plan["chunk_q"]),
                      chunk_kv=int(plan["chunk_kv"]),
                      cache_len=P + G, remat=False,
                      decode_scan=bool(plan["decode_scan"]),
                      mm_tiles=(int(plan["mm_bm"]), int(plan["mm_bn"])))

    # a reduced model draws its weights and prompt on the CPU and moves
    # them to the device, so that the same command serves the same model
    # and prompt on the card and on the CPU; a full-width one draws them
    # on the device
    init_dev = dev if args.full else torch.device("cpu")
    params = lm_mod.init_params(cfg, seed=0, device=init_dev)
    gen = torch.Generator(device=init_dev)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=init_dev)
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, P, cfg.d_model), generator=gen,
                                      device=init_dev)
    if init_dev != dev:
        params = tree_map(lambda t: t.to(dev), params)
        batch = {k: v.to(dev) for k, v in batch.items()}
    return cfg, plan, plan_source, opts, params, batch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = compat.resolve_device(args.device)
    cfg, plan, plan_source, opts, params, batch = setup(args, dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    total = P + G

    # static-schedule WCET bound for the decode weight pass, built from
    # the SAME plan the steps execute; it sets the step deadline
    n_p = lm_mod.param_count(cfg)
    wcet_s = plan_wcet_s(cfg, plan, B, n_p)
    deadline_s = (args.deadline_ms / 1e3 if args.deadline_ms > 0
                  else wcet_s * args.deadline_slack)
    trace_path = os.environ.get("REPRO_TRACE")
    rec = TraceRecorder(time_unit="us") if trace_path else None
    dmon = DeadlineMonitor(deadline_s=deadline_s, trace=rec)

    # untimed: kernel builds, then the prefill and decode graphs
    if dev.type == "cuda":
        _build.build()
    prefill_fn, step = compile_step_fns(cfg, params, batch, opts, P)

    t0 = time.monotonic()
    logits, cache = prefill_fn(batch)
    _sync(dev)
    t_prefill = time.monotonic() - t0
    prefill_launches = {k: n * prefill_fn.replays
                        for k, n in prefill_fn.captured.items()}
    if rec is not None:
        rec.add_span("prefill", "serve", t0 * 1e6,
                     (t0 + t_prefill) * 1e6, cat="serve",
                     batch=B, prompt_len=P)

    out = []
    times = []
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    steppers = [step]
    for i in range(G):
        t1 = time.monotonic()
        logits = step(tok, P + i)
        _sync(dev)
        t2 = time.monotonic()
        times.append(t2 - t1)
        if rec is not None:
            rec.add_span(f"decode{i}", "serve", t1 * 1e6, t2 * 1e6,
                         cat="serve", pos=P + i)
            rec.counter("step_ms", (t2 - t1) * 1e3, track="serve")
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        out.append(tok.cpu().numpy())
        action = dmon.observe(i, t2 - t1)
        if action == "warn":
            print(f"deadline overrun at decode step {i}: "
                  f"{(t2 - t1) * 1e3:.2f} ms > "
                  f"{deadline_s * 1e3:.2f} ms")
        elif action == "shed" and tok.shape[0] > 1:
            n_new = tok.shape[0] // 2
            print(f"deadline ladder: shedding batch "
                  f"{tok.shape[0]} -> {n_new} at decode step {i}")
            cache, tok = shed_batch(cfg, cache, tok, n_new, total,
                                    opts.windowed_cache)
            # new batch shape = new graph, captured outside the step
            # timing so the shed path stays capture-free too
            step = decode_stepper(cfg, params, cache, tok, P + i + 1, opts)
            steppers.append(step)
    replayed = {k: sum(s.captured[k] * s.replays for s in steppers)
                for k in steppers[0].captured}

    times = np.array(times)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {dev} ({name}), {cfg.name} {cfg.num_layers}L "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} {cfg.dtype}, "
          f"{n_p:,} params")
    print(f"serving plan [{plan_source}]: {plan_sig(plan)}")
    print(f"prefill: {t_prefill*1e3:.1f} ms for {B}x{P} tokens")
    print(f"decode:  median {np.median(times)*1e3:.2f} ms/step  "
          f"std {times.std()*1e3:.3f} ms  "
          f"jitter(max-min) {(times.max()-times.min())*1e3:.3f} ms")
    if len({o.shape for o in out}) == 1:
        print(f"generated shape: {np.stack(out, 1).shape}")
    else:
        print(f"generated: {len(out)} steps, batch shed to "
              f"{out[-1].shape[0]} (started at {B})")
    if dev.type == "cuda":
        print(f"prefill graph: kernel launches per replay "
              f"{prefill_fn.captured}")
        print(f"decode graph: {sum(s.replays for s in steppers)} replays, "
              f"kernel launches per replay {steppers[-1].captured}, "
              f"replayed in all {replayed}")
    print(f"H100 WCET bound per step (weight pass, "
          f"plan tiles {plan['mm_bm']}x{plan['mm_bn']}): "
          f"{wcet_s*1e3:.3f} ms")
    s = dmon.summary()
    print(f"deadline: {s['deadline_s']*1e3:.3f} ms/step  "
          f"overruns {s['overruns']}/{len(times)}  "
          f"ladder record/warn/shed "
          f"{s['n_record']}/{s['n_warn']}/{s['n_shed']}  "
          f"worst overrun {s['worst_overrun_s']*1e3:.3f} ms")
    if rec is not None and rec.spans:
        write_chrome_trace(rec, trace_path)
        print(f"trace: {len(rec.spans)} spans -> {trace_path}")
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": times,
            "jitter": jitter_stats(times, wcet_bound=wcet_s).as_dict(),
            "wcet_s": wcet_s, "deadline": s, "plan": plan,
            "replayed_launches": replayed,
            "prefill_launches": prefill_launches,
            "plan_source": plan_source, "device": str(dev),
            "device_name": name, "n_params": n_p}


if __name__ == "__main__":
    main()
