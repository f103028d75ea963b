"""Training launcher of the port (the reference's ``launch/train.py``,
with its flags and ``--device``).

CPU-friendly reduced configs by default; ``--full`` builds the
published architecture, which on the port trains on one card for a
model that fits there (qwen2-0.5b: 494,032,768 parameters; the step's
state is ~5.9 GB: bf16 parameters and gradients, fp32 moments).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 20 --seq 64                                  # reduced
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --full --steps 12 --batch 4 --seq 4096               # on the card

On CUDA every forward and backward product of the step is an
``spm_matmul`` launch and every prefill-form attention a
``flash_attention`` launch (its backward, ``attention_grad``,
recomputes the attention under autograd); an RWKV model raises
(``wkv6`` has no backward).  The kernels are built before the first
step.  The step deadline follows the
reference's recipe: 3 x the one-pass WCET bound (the weight pass over
batch x seq tokens, tiled by ``tuning.model.kernel_pins``; forward,
grad-wrt-input and grad-wrt-weight each stream every weight) x
``--deadline-slack``, from ``core.gpu_mapping.serve_step_wcet``
(``gpu_wcet`` of ``serve_step_schedule``, in closed form).

It prints the first and last loss, the step times (median, p99, CoV
over the steps after the first two, which pay the first calls), tokens
per second, the model-FLOP share of the card's bf16 peak under two
definitions (``model_flops``: 6 x params x tokens plus causal
attention; the reference's ``analysis.flops.model_flops``: 6 x active
params x tokens), the peak device memory, the kernel launches per step, the deadline summary and
the card's name and power limit.  ``main`` returns them.

The loss is chunked every ``LOSS_CHUNK`` positions, where the
reference's launcher takes 64: on the card 64 makes batch x 64-row
logits products, each re-reading the whole [V, d] table and each
leaving a full-size table gradient to sum.  The loss does not depend
on the chunking.

Set ``REPRO_TRACE=/path/train.json`` to record every training step as
a span on the ``trainer`` track and dump a Chrome trace at exit.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.analysis import flops as analysis_flops
from repro_torch.configs import (ShapeConfig, TrainConfig, get_config,
                                  reduce_config)
from repro_torch.core.gpu_mapping import serve_step_wcet
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.spm_matmul import ops as spm_ops
from repro_torch.models.lm import RunOptions, param_count
from repro_torch.obs import TraceRecorder, jitter_stats, write_chrome_trace
from repro_torch.resilience.deadline import DeadlineMonitor
from repro_torch.runtime.trainer import Trainer
from repro_torch.tuning.model import ModelProblem, kernel_pins

# H100 SXM bf16 dense tensor-core peak (datasheet)
BF16_PEAK_FLOPS = 989e12
# positions per loss chunk (RunOptions' default; see the module note)
LOSS_CHUNK = 512


def reduced_config(cfg, args):
    """CLI shim over configs.reduce_config (the shared shrink the
    serving autotuner keys its plans on)."""
    return reduce_config(cfg, layers=args.layers, d_model=args.d_model,
                         vocab=args.vocab)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="use the published architecture size")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="explicit per-step deadline; 0 = derive from "
                         "the WCET bound")
    ap.add_argument("--deadline-slack", type=float, default=50.0,
                    help="deadline = 3 x one-pass WCET bound x slack")
    ap.add_argument("--device", default="cuda",
                    help="cuda (an sm_90 card) or cpu")
    return ap


def model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of a dense decoder: 6 x
    parameters x tokens for the weight products (forward,
    grad-wrt-input, grad-wrt-weight), plus causal attention's two
    products over half the S x S pairs, forward and backward (3x), in
    each of its layers."""
    a = cfg.attention
    attn = (3 * 2 * batch * a.num_heads * seq * seq * a.head_dim
            * cfg.num_layers if a is not None else 0)
    return 6.0 * param_count(cfg) * batch * seq + attn


def reference_model_flops(cfg, batch: int, seq: int) -> float:
    """The reference's definition (``analysis.flops.model_flops``):
    6 x active parameters x tokens, no attention term."""
    return analysis_flops.model_flops(
        cfg, ShapeConfig("train", seq, batch, "train"))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = compat.resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg, args)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps,
                       microbatch=args.microbatch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size,
                      global_batch=args.batch, seq_len=args.seq)
    opts = RunOptions(chunk_q=64, chunk_kv=64, loss_chunk=LOSS_CHUNK,
                      remat=False)

    trace_path = os.environ.get("REPRO_TRACE")
    rec = TraceRecorder(time_unit="us") if trace_path else None

    # WCET-derived step deadline, the reference's recipe: the weight
    # pass over B*S tokens, tiled by the resolved kernel plan; the
    # forward+backward pass streams each weight ~3x, hence the 3x
    tokens = args.batch * args.seq
    prob = ModelProblem(args.arch, tokens, args.seq, 1,
                        layers=0 if args.full else args.layers,
                        d_model=args.d_model, vocab=args.vocab)
    n_p = param_count(cfg)
    wcet_s = 3.0 * serve_step_wcet(tokens, cfg.d_model, n_p,
                                   plan=kernel_pins(cfg, prob))
    deadline_s = (args.deadline_ms / 1e3 if args.deadline_ms > 0
                  else wcet_s * args.deadline_slack)
    dmon = DeadlineMonitor(deadline_s=deadline_s, trace=rec)

    # each step's launches, read from the wrappers' counters, and its
    # gradient norm (before the clip)
    per_step, grad_norms = [], []

    def counts():
        return {"spm_matmul": dict(spm_ops.matmul.paths),
                "flash_attention": flash_ops.attention.launches}

    last = counts()

    def on_metrics(step, metrics):
        now = counts()
        per_step.append({
            "spm_matmul": {k: n - last["spm_matmul"][k]
                           for k, n in now["spm_matmul"].items()},
            "flash_attention": now["flash_attention"]
            - last["flash_attention"]})
        last.update(now)
        grad_norms.append(float(metrics["grad_norm"]))

    if dev.type == "cuda":
        _build.build()
        torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, tcfg, dcfg, ckpt_dir=args.ckpt_dir, opts=opts,
                 trace=rec, deadline=dmon, device=dev,
                 on_metrics=on_metrics)
    last.update(counts())
    hist = tr.run(args.steps)

    times = np.array(hist["step_time_s"])
    steady = times[2:] if len(times) > 2 else times
    js = jitter_stats(steady)
    p99 = float(np.percentile(steady, 99))
    flops = model_flops(cfg, args.batch, args.seq)
    ref_flops = reference_model_flops(cfg, args.batch, args.seq)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    ident = compat.device_identity() if dev.type == "cuda" else {}
    peak_mem = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
    print(f"device: {dev} ({name}"
          + (f", power limit {ident['power_limit_w']} W" if ident else "")
          + f"), {cfg.name} {cfg.num_layers}L d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, {n_p:,} params, "
          f"batch {args.batch} x seq {args.seq}")
    print(f"first loss {hist['loss'][0]:.4f} -> last "
          f"{hist['loss'][-1]:.4f} in {hist['wall_s'][0]:.1f}s; gradient "
          f"norm {grad_norms[0]:.4g} -> {grad_norms[-1]:.4g}")
    print(f"step: median {js.median * 1e3:.2f} ms  p99 {p99 * 1e3:.2f} ms"
          f"  CoV {js.cov:.4f} over steps 3-{len(times)}; "
          f"{tokens / js.median:,.0f} tokens/s")
    share = flops / (js.median * BF16_PEAK_FLOPS)
    ref_share = ref_flops / (js.median * BF16_PEAK_FLOPS)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"model FLOPs {flops:.4g} a step (6 x params x tokens + "
              f"causal attention): {share:.4f} of the bf16 peak "
              f"({BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s, datasheet); the "
              f"reference's analysis.flops.model_flops (6 x active params "
              f"x tokens) {ref_flops:.4g}: {ref_share:.4f}; "
              f"peak memory {peak_mem / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated) of "
              f"{total / 2**30:.0f}")
        print(f"launches per step: {per_step[-1]}")
    print(f"H100 WCET bound per step (fwd+bwd weight passes): "
          f"{wcet_s*1e3:.3f} ms")
    s = dmon.summary()
    print(f"deadline: {s['deadline_s']*1e3:.3f} ms/step  "
          f"overruns {s['overruns']}  ladder record/warn/shed "
          f"{s['n_record']}/{s['n_warn']}/{s['n_shed']}  "
          f"worst overrun {s['worst_overrun_s']*1e3:.3f} ms")

    if rec is not None and rec.spans:
        write_chrome_trace(rec, trace_path)
        print(f"trace: {len(rec.spans)} spans -> {trace_path}")
    return {"loss": hist["loss"], "step_s": times.tolist(),
            "jitter": js.as_dict(), "p99_s": p99,
            "tokens_per_s": tokens / js.median, "model_flops": flops,
            "peak_flop_share": share, "reference_model_flops": ref_flops,
            "reference_peak_flop_share": ref_share, "peak_memory": peak_mem,
            "launches_per_step": per_step, "grad_norm": grad_norms,
            "wcet_s": wcet_s,
            "deadline": s, "n_params": n_p, "device": str(dev),
            "device_name": name, "identity": ident,
            "final_state": tr.final_state, "trainer": tr}


if __name__ == "__main__":
    main()
