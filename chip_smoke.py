#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an H100.

  python3 chip_smoke.py          # from the root of a checkout, one card

Phases, one result line each; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and capability;
            anything but sm_90 fails.
2. build    nvcc builds every kernel of ``src/repro_torch/csrc`` for
            sm_90a, one process per source, all at once, and prints
            each kernel's registers and spills (``-Xptxas -v``).
3. kernels  each kernel against its plain PyTorch version on the card,
            at the shapes the main paths give it (bf16), at edge shapes
            and at the reference's conformance shapes, element by
            element (``repro_torch.kernels.tolerance`` states the
            allowance and why): the worst error as a share of its
            allowance, which must stay under 1, and the same reading of
            planted faults, which must exceed 1 (spm_matmul: one 16-deep
            K step dropped; flash_attention: a 5 % error in the scale;
            wkv6: the u bonus dropped, the state not carried across the
            boundary between two blocks' chunks and, where a cluster
            walks more than one group, between two groups, the decay off
            by one position).  Each case records the kernel path its
            wrapper launched (and the split count, or wkv6's rows per
            block and cluster): the main path's bf16 shapes must take
            the redesigned paths (spm_matmul: cluster split-K for decode
            products but the logits, wgmma for prefill; flash_attention
            and wkv6: the tensor-core kernels), fp32 and unaligned
            operands the older kernels.  Each main-path case runs twice
            and must give the same bits.  wkv6's serve shape runs once
            more through the kernel built with its per-step clock
            counters (``WKV6_STEP_CLOCKS``), which say which step of a
            block takes its time.  flash_attention's cases carry Sq and
            Sk apart: whisper's cross-attention shapes (Sq != Sk, both
            ways round, bf16 and fp32, unmasked) run beside the main
            path's.  Then the kernel's time, the plain version's, a
            PyTorch library call's where one computes the same function
            (a yardstick the port never calls) and the bound from the
            datasheet rates.
4. model    reduced qwen2-0.5b, rwkv6-1.6b, qwen3-moe-235b-a22b and
            llama4-maverick-400b-a17b (2 layers), gemma3-12b (its 6
            local and global layers, window 16 under the 64-token
            prompt) and zamba2-7b (15 layers: two units of a tied
            shared-attention block and six Mamba2 layers, so both tied
            blocks run, and a tail of three; two SSD chunks of 32 in the
            prompt), whisper-base (2 decoder and 2 encoder layers, 96
            frames against the 64-token prompt, so the cross-attention
            runs flash at Sq != Sk) and pixtral-12b (2 layers, patch
            embeddings over the first 16 positions), fp32, on the card
            against the same converted parameters on the CPU: prefill
            logits within 1e-4 of the largest logit, 8 greedy tokens
            identical.  Then reduced
            qwen3-moe-235b-a22b through ``repro_torch.launch.serve`` on
            the card and on the CPU: the card replays its captured MoE
            prefill and decode graphs and must give the CPU's tokens.
5. serve    the main paths: ``repro_torch.launch.serve`` at full width
            and depth (qwen2-0.5b and rwkv6-1.6b: 24 layers, prompt 256;
            gemma3-12b: 48 layers, prompt 2048, twice its local window;
            zamba2-7b: 81 Mamba2 layers and 13 tied-block applications,
            prompt 512, two SSD chunks of 256; whisper-base: 6 encoder
            and 6 decoder layers, prompt 1536 and frames as long, the
            config's cross K/V length; pixtral-12b: 40 layers, prompt
            1024, the stub's patch positions, no patches fed; bf16,
            batch 4, 32 new tokens), qwen2-0.5b's with
            ``REPRO_TRACE`` set.  Launch counters are zeroed just before
            each serve and read just after; each kernel of that path
            must have launched, and all 4x32 tokens must come out (a
            deadline shed fails) in range.  The timed prefill and decode
            steps replay CUDA graphs captured before the timing, which
            pass no wrapper: the launches those replays made are read
            from ``serve.main``, and one prefill replay must launch each
            kernel once per layer (spm_matmul once per product), one
            decode replay the step's spm_matmul products (zamba2: 241
            spm_matmul and 13 flash_attention, at head dim 112, a prefill
            replay; 241 spm_matmul a decode replay; whisper-base: 97
            spm_matmul and 18 flash_attention, encoder, decoder self and
            cross, a prefill replay, 49 spm_matmul a decode replay;
            pixtral-12b: 281 and 40, and 281).  The wrappers
            themselves must have launched for exactly two prefills and
            two decode steps (each graph's eager warm-up and its
            capture), so nothing timed ran eagerly; their path counters
            must show every decode product but the logits on the
            split-K path and every prefill product but the logits on the
            wgmma path (and, for every model but rwkv6-1.6b, every
            flash_attention launch, for rwkv6-1.6b every wkv6 launch,
            on its tensor-core kernel).  Then the same model,
            weights and prompt again through ``serve.compile_step_fns``:
            the prefill graph's logits must be bit-identical to an eager
            ``lm.prefill``'s, and 8 greedy tokens through the graphs
            identical to 8 through eager calls; for whisper-base's
            padded vocabulary, the logits past 51,865 of the prefill
            replay and of a decode replay all -1e30, no argmax there.
6. trace    each served model's decode graph, and gemma3-12b's and
            zamba2-7b's prefill graphs, replayed under
            ``torch.profiler``: the replay's time (CUDA events), the
            device's busy share, and its kernels' device time by family.
7. predictability  the jitter statistics (median, p99, spread, CoV,
            WCET margin) of each serve's 32 decode steps and of its
            prefill graph's replays timed by CUDA events (10 for qwen2,
            rwkv6 and whisper, 3 for gemma3, zamba2 and pixtral), as a
            schema-v1 report
            (``repro_torch.obs.make_report``) that
            ``repro_torch.obs.validate_report`` must accept, written to
            ``chiprun_out/chip_smoke_report.json``; and qwen2's
            ``REPRO_TRACE`` file must hold 1 ``prefill`` span, 32
            ``decode*`` spans and 32 ``step_ms`` counters.

8. tune    the jitter-aware autotuner (``repro_torch.tuning``) on the
            card, with a fresh plan cache at
            ``chiprun_out/tuning_plans.json`` (phases 1-7 run with
            ``REPRO_AUTOTUNE=0``, so they read no cache and launch what
            they launched before tuning existed).  Cold: each of
            ``tune_cases()`` (main-path shapes, bf16) enumerated, pruned and
            measured; every measured candidate is first held to its plain
            version by phase 3's element-wise rule (a candidate over its
            allowance fails the run); per shape the candidates, how many
            are feasible and measured, the winner with the path and split
            it launches, and the winner's and the default's p99 and CoV
            in us (CUDA events over graph replays of launches cycling
            through input copies that exceed L2).  Warm: the same again
            must make 0 measurement spans and return the same plans.
            An unpinned call must follow a tiled plan put in a cache
            for it, and launch split-K again with ``REPRO_AUTOTUNE=0``.
            Then ``python -m repro_torch.launch.tune --model qwen2-0.5b
            --layers 0 --shape 4x256x32 --dtype bfloat16``: its two
            decode programs measured as full captured serve passes, tuned
            and default us/token, p99 and CoV.  Last, phase 5's qwen2
            serve on the tuned cache: its plan source must say ``cache``,
            its wrappers' path counters must be those the cached plans
            give each product (``ops.launch_plan``), its wrappers must
            have launched for two prefills and two decode steps, and its
            captured prefill's logits must equal an eager prefill's.

9. train    the training path, with no plan cache (``REPRO_AUTOTUNE=0``).
            (a) the backward's products at qwen2-0.5b's training widths
            (T = 4 x 4096 rows; d 896, k/v 128, FFN 4864): each layer
            product's dA (``ops.grad_a``: ``trans_b`` on the weight as
            it lies) and dB (``ops.grad_b``: on the transposed copy of
            the smaller of A and dC), and a loss chunk's logits (2048
            rows against the 151,936-row table): the fp32-out forward,
            dA from dC rounded to bf16 (beside the plain fp32 product of
            the unrounded dC: its time and its difference) and dB;
            plus the forward flash launch at [4, 4096, 14/2, 64]; each
            held element by element to its plain version with a
            planted fault caught (phase 3's rule), run twice for the
            same bits, with its path, time, ``torch.mm``'s (SDPA's)
            and its bound.  (b) reduced qwen2 fp32 (2 layers, remat
            on): one step's gradient of every leaf and 5 steps of loss
            on the card against the CPU, within 1e-4.  (c)
            ``python -m repro_torch.launch.train --arch qwen2-0.5b
            --full --steps 12 --batch 4 --seq 4096`` (TRAIN_4K's
            sequence; the global batch cut from 256 to 4 for one card),
            counters zeroed just before and read just after: the last
            loss must be below the first, and so must the first step's
            batch's loss under the trained parameters, every step must
            launch the spm_matmul paths and the flash count reckoned
            from the code (``train_products``), and it prints the step
            ms (median, p99, CoV over steps 3-12), tokens/s, the
            model-FLOP share of the bf16 peak, the peak memory and the
            deadline's overruns; one more step traced by kernel family.
            Then, from the trained state on the first batch: the step
            under variants of the training path (per-unit indexing of
            the stacked leaves, every loss chunk's logits kept, remat),
            timed with their peak memory, the loss the same bits in
            each (``train_variants``); 5 steps on that batch alone,
            printed; and the same 5 steps at the same widths at 2
            layers from init must lower the batch's loss by more than
            10 x the spread of 4 batches' losses, with every leaf's
            first moment non-zero and every leaf drawn at random moved
            (``train_descent``: at 24 layers the init's gradient is too
            large for a step to move the loss).
            (d) a reduced bf16 run with a NaN step, then a save, a
            preemption and a resume, bit-identical in the parameters
            and the optimizer state to an undisturbed run.

10. dryrun  the port's dry run and roofline on the production meshes,
            each command in a subprocess of its own on the host's CPU
            (a ``fake`` process group of 256 or 512 ranks, ``meta``
            DTensors: full-size models, no memory):
            ``python -m repro_torch.launch.dryrun --arch qwen2-0.5b
            --shape train_4k --multi-pod both`` (16x16 and 2x16x16),
            ``python -m repro_torch.launch.roofline_run --arch
            qwen2-0.5b --shape decode_32k``, and the same two for
            zamba2-7b at prefill_32k on 16x16.  Each record's status
            must be ok; it prints the per-device FLOPs, the collective
            bytes by kind and the roofline terms at the H100's rates
            (``repro_torch.analysis.roofline``; a dry-run record's
            memory term from its unfused traced bytes, a roofline
            record's from the analytic bytes model).

Then one JSON line with every kernel's numbers, the nvidia-smi line,
and, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside this file, it fails before printing
any result.  Per-case numbers also go to ``chiprun_out/chip_smoke.json``.
``python3 chip_smoke.py 9`` runs phases 1, 2 and 9 only and prints no
result lines (``chiprun_out/chip_smoke_train.json``); ``python3
chip_smoke.py 10`` runs phases 1 and 10 only, likewise
(``chiprun_out/chip_smoke_dryrun.json``).
"""
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM datasheet rates (dense): the bound of each kernel case
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# card vs CPU through the reduced fp32 layers: differently ordered sums
# in every product, and CUDA's and the CPU's exp/rsqrt
MODEL_TOL = 1e-4
L2_BYTES = 50 * 2 ** 20


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want):
    diff = (got.float() - want.float()).abs().max().item()
    return diff / (want.float().abs().max().item() + 1e-9), diff


def time_ms(fn, arg_sets, min_reps=20):
    """Device ms per call.  The calls are captured into one CUDA graph
    and the graph is replayed between CUDA events, so the host's launch
    cost stays out of the number; the median of three replays counts.
    The calls cycle through ``arg_sets`` (distinct copies of the
    weights that together exceed L2), so each call finds its weights
    cold, as the main path does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    reps = max(min_reps, len(arg_sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[1]


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this needs an H100")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    print(f"phase 1 device: {smi}; capability {cap}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    if tuple(cap) != (9, 0):
        fail(f"capability {cap} is not sm_90")
    from repro_torch import compat
    return compat.resolve_device("cuda"), smi


def phase_build():
    """Build the kernels; returns the build time and, per kernel entry,
    ptxas's register and spill lines."""
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    logs = _build.build(_build.SOURCES + tuple(_build.VARIANTS),
                        ptxas_verbose=True)
    secs = time.monotonic() - t0
    print(f"phase 2 build: {sorted(_build.SOURCES)} and the variants "
          f"{sorted(_build.VARIANTS)} with {' '.join(_build.NVCC_FLAGS)} "
          f"in {secs:.1f} s (newly built: {sorted(logs)})", flush=True)
    usage = {}
    for name, text in logs.items():
        if name not in _build.SOURCES:
            continue
        entry = None
        for line in text.splitlines():
            if "Compiling entry function" in line and "'" in line:
                entry = line.split("'")[1]
            elif entry and ("registers" in line or "spill" in line):
                usage.setdefault(entry, []).append(
                    line.split(":", 1)[-1].strip())
    for entry, lines in usage.items():
        print(f"  {entry}: {'; '.join(lines)}")
    return secs, usage


# ----------------------------------------------------------- kernels

def matmul_cases():
    """(label, m, k, n, trans_b, dtype, out_dtype, plan, main_path);
    the main path's shapes of qwen2-0.5b, of rwkv6-1.6b, of gemma3-12b
    (prefill M = 4 x 2048; the tied logits read the 262,144 x 3840
    table, 2.01 GB, in place), of zamba2-7b (prefill M = 4 x 512;
    in_proj's N = 14,576 leaves 48 columns past the split-K tiles and
    112 past the wgmma tiles), of whisper-base (K = 512 at M = 6144 on
    wgmma: 8 K steps a tile) and of pixtral-12b (d 5120)."""
    from repro_torch.kernels import CONFORMANCE_SHAPES
    bf, f32 = torch.bfloat16, torch.float32
    d, ff, V, B, BP = 896, 4864, 151_936, 4, 4 * 256
    cases = []
    for phase, m in (("decode", B), ("prefill", BP)):
        for what, k, n in (("q/o proj", d, d), ("k/v proj", d, 128),
                           ("gate/up", d, ff), ("down", ff, d)):
            cases.append((f"{phase} {what}", m, k, n, False, bf, None,
                          {}, True))
    cases.append(("logits (tied embed^T)", B, d, V, True, bf, f32, {},
                  True))
    rd, rff, rV = 2048, 7168, 65_536
    for phase, m in (("decode", B), ("prefill", BP)):
        for what, k, n in (("r/k/v/g/o, cm r", rd, rd), ("cm k", rd, rff),
                           ("cm v", rff, rd), ("mix_w1", rd, 160),
                           ("mix_w2 (x5)", 32, rd), ("wd_w1", rd, 64),
                           ("wd_w2", 64, rd)):
            cases.append((f"rwkv {phase} {what}", m, k, n, False, bf, None,
                          {}, True))
    cases.append(("rwkv logits (lm_head^T)", B, rd, rV, True, bf, f32, {},
                  True))
    gd, gq, gkv, gff, gV, GP = 3840, 4096, 2048, 15_360, 262_144, 4 * 2048
    for phase, m in (("decode", B), ("prefill", GP)):
        for what, k, n in (("q proj", gd, gq), ("k/v proj", gd, gkv),
                           ("o proj", gq, gd), ("gate/up", gd, gff),
                           ("down", gff, gd)):
            cases.append((f"gemma3 {phase} {what}", m, k, n, False, bf, None,
                          {}, True))
    cases.append(("gemma3 logits (tied embed^T)", B, gd, gV, True, bf, f32,
                  {}, True))
    zd, zi, zp, zff, zV, ZP = 3584, 7168, 14_576, 14_336, 32_000, 4 * 512
    for phase, m in (("decode", B), ("prefill", ZP)):
        for what, k, n in (("in_proj", zd, zp),
                           ("out_proj, shared q/k/v", zi, zd),
                           ("shared o", zd, zd), ("shared ffn up", zd, zff),
                           ("shared ffn down", zff, zd)):
            cases.append((f"zamba2 {phase} {what}", m, k, n, False, bf, None,
                          {}, True))
    cases.append(("zamba2 logits (lm_head^T)", B, zd, zV, True, bf, f32, {},
                  True))
    # whisper-base: prefill M = 4 x 1536 (frames as long as the prompt);
    # q/k/v/o of the encoder, decoder self and cross blocks are all
    # 512 x 512; the logits read the padded 51,968-row table
    wd, wff, wV, WP = 512, 2048, 51_968, 4 * 1536
    for phase, m in (("decode", B), ("prefill", WP)):
        for what, k, n in (("q/k/v/o (self, cross, encoder)", wd, wd),
                           ("ffn up", wd, wff), ("ffn down", wff, wd)):
            cases.append((f"whisper {phase} {what}", m, k, n, False, bf,
                          None, {}, True))
    cases.append(("whisper logits (lm_head^T)", B, wd, wV, True, bf, f32, {},
                  True))
    # pixtral-12b: prefill M = 4 x 1024
    pd, pq, pkv, pff, pV, PP = 5120, 4096, 1024, 14_336, 131_072, 4 * 1024
    for phase, m in (("decode", B), ("prefill", PP)):
        for what, k, n in (("q proj", pd, pq), ("k/v proj", pd, pkv),
                           ("o proj", pq, pd), ("gate/up", pd, pff),
                           ("down", pff, pd)):
            cases.append((f"pixtral {phase} {what}", m, k, n, False, bf,
                          None, {}, True))
    cases.append(("pixtral logits (lm_head^T)", B, pd, pV, True, bf, f32, {},
                  True))
    cases.append(("logits at M=B*P", BP, d, V, True, bf, f32, {}, False))
    for m in (1, 2, 48, 259):
        cases.append((f"ragged M={m}", m, d, d, False, bf, None, {},
                      False))
    # rows off the 16-byte grid (A = a [4, 897] slice's last 896 columns)
    cases.append(("unaligned bf16", B, d, d, False, bf, None, {}, False))
    for m, k, n, bm, bn, bk, dt in CONFORMANCE_SHAPES["spm_matmul"]:
        cases.append(("conformance", m, k, n, False, getattr(torch, dt),
                      None, {"bm": bm, "bn": bn, "bk": bk}, False))
    return cases


def flash_cases():
    """(label, B, Sq, Sk, H, KV, D, causal, window, dtype, main_path).
    whisper-base's cross-attention prefill at the served prompt has the
    encoder's shape (Sq = Sk = 1536, unmasked); Sq != Sk runs off the
    main path: its 448-token decoder context against the 1500 frames of
    its 30 s window, fp32, and Sq > Sk."""
    from repro_torch.kernels import CONFORMANCE_SHAPES
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("serve prefill", 4, 256, 256, 14, 2, 64, True, 0, bf, True),
             ("gemma3 prefill, global", 4, 2048, 2048, 16, 8, 256, True, 0,
              bf, True),
             ("gemma3 prefill, local", 4, 2048, 2048, 16, 8, 256, True,
              1024, bf, True),
             ("zamba2 shared-attention prefill", 4, 512, 512, 32, 32, 112,
              True, 0, bf, True),
             ("whisper encoder and cross prefill", 4, 1536, 1536, 8, 8, 64,
              False, 0, bf, True),
             ("whisper decoder self prefill", 4, 1536, 1536, 8, 8, 64,
              True, 0, bf, True),
             ("pixtral prefill", 4, 1024, 1024, 32, 8, 128, True, 0, bf,
              True),
             ("cross Sq 448 Sk 1500", 4, 448, 1500, 8, 8, 64, False, 0, bf,
              False),
             ("cross fp32 Sq 100 Sk 300", 2, 100, 300, 8, 8, 64, False, 0,
              f32, False),
             ("cross Sq 200 > Sk 64", 2, 200, 64, 8, 8, 64, False, 0, bf,
              False),
             ("ragged S=100 D=112", 2, 100, 100, 8, 8, 112, True, 0, bf,
              False),
             ("fp32 D=112", 1, 256, 256, 4, 4, 112, True, 0, f32, False),
             ("unaligned bf16 D=112", 1, 128, 128, 4, 4, 112, True, 0, bf,
              False),
             ("ragged S=100 D=256 window 24", 2, 100, 100, 4, 2, 256, True,
              24, bf, False),
             ("fp32 D=256 window 64", 1, 256, 256, 4, 2, 256, True, 64, f32,
              False),
             ("unaligned bf16 D=256", 1, 128, 128, 4, 2, 256, True, 0, bf,
              False),
             ("windowed", 4, 256, 256, 14, 2, 64, True, 64, bf, False),
             ("non-causal", 4, 256, 256, 14, 2, 64, False, 0, bf, False),
             ("ragged S=100", 2, 100, 100, 14, 2, 64, True, 0, bf, False),
             ("S=100 window 24", 1, 100, 100, 4, 1, 32, True, 24, bf,
              False),
             ("unaligned bf16", 2, 100, 100, 4, 1, 64, True, 0, bf, False),
             ("ragged S=100 fp32", 2, 100, 100, 4, 1, 128, True, 0, f32,
              False)]
    for b, sq, sk, h, kv, d, causal, w, dt in \
            CONFORMANCE_SHAPES["flash_attention"]:
        cases.append(("conformance", b, sq, sk, h, kv, d, causal, w,
                      getattr(torch, dt), False))
    return cases


def wkv_cases():
    """(label, B, S, H, K, chunk, dtype, decay, main_path)."""
    from repro_torch.kernels import CONFORMANCE_SHAPES
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("serve prefill", 4, 256, 32, 64, 256, bf, "model", True),
             ("strong decay", 1, 256, 2, 64, None, f32, "strong", False),
             ("strong decay bf16", 1, 256, 2, 64, None, bf, "strong",
              False),
             ("long S=2048", 1, 2048, 32, 64, 256, bf, "model", False),
             ("chunk halved, K=128", 2, 256, 4, 128, 128, bf, "model",
              False),
             ("ragged S=100", 2, 100, 2, 64, 64, bf, "model", False),
             ("unaligned bf16", 2, 100, 2, 64, 64, bf, "model", False)]
    for b, s, h, k, chunk, dt in CONFORMANCE_SHAPES["wkv6"]:
        cases.append(("conformance", b, s, h, k, chunk, getattr(torch, dt),
                      "reference", False))
    return cases


def mask_of(Sq, Sk, causal, window, dev):
    """[Sq, Sk] bool: the (q, k) pairs the kernel must attend to."""
    q = torch.arange(Sq, device=dev)[:, None]
    k = torch.arange(Sk, device=dev)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= (q - k) < window
    return ok


def run_matmul(dev, gen):
    from repro_torch.kernels.spm_matmul import ops
    from repro_torch.kernels.tolerance import ATOL_FRAC, RTOL, check
    rows = []
    for label, m, k, n, tb, dt, out, plan, main in matmul_cases():
        a = torch.randn(m, k + (label == "unaligned bf16"), generator=gen,
                        device=dev).to(dt)[:, -k:]
        bshape = (n, k) if tb else (k, n)
        b = (torch.randn(*bshape, generator=gen, device=dev)
             / math.sqrt(k)).to(dt)
        before = dict(ops.matmul.paths)
        got = ops.matmul(a, b, trans_b=tb, out_dtype=out, **plan)
        torch.cuda.synchronize()
        path = launched_path(ops.matmul.paths, before)
        route = ops.route(a, b, tb, **plan)
        want_path = expected_matmul_path(label, m, dt, tb)
        if path != route["path"] or path != want_path:
            fail(f"spm_matmul {label} {m}x{k}x{n}: launched {path}, "
                 f"dispatch says {route['path']}, expected {want_path}")
        if main and not torch.equal(got, ops.matmul(a, b, trans_b=tb,
                                                    out_dtype=out)):
            fail(f"spm_matmul {label} {m}x{k}x{n}: two runs differ")
        want = ops.matmul_plain(a, b, out, trans_b=tb)
        ratio, diff = check(got, want, dt)
        if not ratio < 1:
            fail(f"spm_matmul {label} {m}x{k}x{n}: error at {ratio:.3f} "
                 f"of its allowance")
        # planted fault: the kernel on A with its last 16-deep K step
        # zeroed, as if one MMA step were dropped; the check must see it
        dropped = a.clone()
        dropped[:, -16:] = 0
        fault, _ = check(ops.matmul(dropped, b, trans_b=tb, out_dtype=out,
                                    **plan), want, dt)
        if not fault > 1:
            fail(f"spm_matmul {label}: the check misses a dropped K step "
                 f"({fault:.3f} of its allowance)")
        row = {"kernel": "spm_matmul", "case": label, "shape": [m, k, n],
               "trans_b": tb, "dtype": str(dt), "path": path,
               "splits": route["splits"], "deterministic": main or None,
               "err_ratio": ratio,
               "fault_ratio": fault, "max_abs_err": diff, "rtol": RTOL[dt],
               "atol_frac": ATOL_FRAC[dt], "main_path": main}
        copies = max(1, min(512, math.ceil(
            2 * L2_BYTES / b.numel() / b.element_size())))
        sets = [(a, b)] + [(a, b.clone()) for _ in range(copies - 1)]
        row["ms"] = time_ms(
            lambda x, y: ops.matmul(x, y, trans_b=tb, out_dtype=out), sets)
        row["plain_ms"] = time_ms(
            lambda x, y: ops.matmul_plain(x, y, out, trans_b=tb), sets)
        row["library_ms"] = library_matmul_ms(sets, tb, out)
        out_bytes = torch.empty((), dtype=out or dt).element_size()
        nbytes = (a.numel() + b.numel()) * a.element_size() \
            + m * n * out_bytes
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * m * n * k, dt)
        del sets
        rows.append(row)
        print(f"  spm_matmul {label:24s} {m}x{k}x{n} {str(dt)[6:]:8s} "
              f"{path} x{route['splits']}  "
              f"err {ratio:.3f} of allowance (dropped K step "
              f"{fault:.1f})  max abs {diff:.2e}  kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
              f"library {row['library_ms']} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return rows


def launched_path(paths, before):
    """The one path whose launch counter moved since ``before``."""
    moved = [p for p, n in paths.items() if n != before[p]]
    if len(moved) != 1 or paths[moved[0]] != before[moved[0]] + 1:
        fail(f"expected one launch on one path: {before} -> {paths}")
    return moved[0]


def expected_matmul_path(label, m, dtype, trans_b):
    """The path a case must take: the tiled kernel for fp32 and
    unaligned operands and for the conformance plans (their pins, bk 0
    among them, name tiles no other path runs); for bf16 the split-K
    path at M <= 16 but the transposed-B logits, wgmma at M >= 64, the
    tiled kernel in between."""
    if dtype == torch.float32 or label in ("unaligned bf16", "conformance"):
        return "tiled"
    if m <= 16:
        return "tiled" if trans_b else "splitk"
    return "wgmma" if m >= 64 else "tiled"


def library_matmul_ms(sets, trans_b, out):
    """torch.mm as the yardstick; the fp32-output logits need
    ``out_dtype``, which older torch builds lack (then null)."""
    if out is None:
        return time_ms(lambda x, y: torch.mm(x, y.t() if trans_b else y),
                       sets)
    a, b = sets[0]
    try:
        torch.mm(a, b.t(), out_dtype=out)
    except (TypeError, RuntimeError, NotImplementedError) as exc:
        print(f"  (no library yardstick for fp32-output mm: {exc})")
        return None
    return time_ms(lambda x, y: torch.mm(x, y.t(), out_dtype=out), sets)


def run_flash(dev, gen):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.tolerance import ATOL_FRAC, RTOL, check
    rows = []
    for label, B, Sq, Sk, H, KV, D, causal, w, dt, main in flash_cases():
        # "unaligned": each head's row one element off the 16-byte grid
        off = int(label.startswith("unaligned"))
        q, k, v = (torch.randn(B, s, n, D + off, generator=gen,
                               device=dev).to(dt)[..., off:]
                   for s, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        before = dict(ops.attention.paths)
        got = ops.attention(q, k, v, causal=causal, window=w)
        torch.cuda.synchronize()
        path = launched_path(ops.attention.paths, before)
        want_path = ("tensor_core" if dt == torch.bfloat16 and not off
                     else "fma")
        if path != want_path:
            fail(f"flash_attention {label}: launched {path}, expected "
                 f"{want_path}")
        if main and not torch.equal(got, ops.attention(
                q, k, v, causal=causal, window=w)):
            fail(f"flash_attention {label}: two runs differ")
        want = ops.attention_plain(q, k, v, causal=causal, window=w)
        ratio, diff = check(got, want, dt)
        if not torch.isfinite(got).all() or not ratio < 1:
            fail(f"flash_attention {label}: error at {ratio:.3f} of its "
                 f"allowance")
        # planted fault: the kernel with its scale 5 % off
        fault, _ = check(ops.attention(q, k, v, causal=causal, window=w,
                                       scale=1.05 / math.sqrt(D)), want, dt)
        if not fault > 1:
            fail(f"flash_attention {label}: the check misses a 5 % scale "
                 f"error ({fault:.3f} of its allowance)")
        row = {"kernel": "flash_attention", "case": label,
               "shape": [B, Sq, Sk, H, KV, D], "causal": causal,
               "window": w,
               "dtype": str(dt), "path": path,
               "deterministic": main or None, "err_ratio": ratio,
               "fault_ratio": fault,
               "max_abs_err": diff, "rtol": RTOL[dt],
               "atol_frac": ATOL_FRAC[dt], "main_path": main}
        sets = [(q, k, v)]
        row["ms"] = time_ms(lambda x, y, z: ops.attention(
            x, y, z, causal=causal, window=w), sets)
        row["plain_ms"] = time_ms(lambda x, y, z: ops.attention_plain(
            x, y, z, causal=causal, window=w), sets)
        mask = mask_of(Sq, Sk, causal, w, dev)
        row["library_ms"], row["library_backend"] = library_attention_ms(
            q, k, v, causal, w, mask)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * D * int(mask.sum()) * B * H
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
        rows.append(row)
        print(f"  flash_attention {label:18s} B{B} Sq{Sq} Sk{Sk} H{H} "
              f"KV{KV} D{D} "
              f"causal={causal} window={w} {str(dt)[6:]:8s} {path} err "
              f"{ratio:.3f} of allowance (scale x1.05 {fault:.1f})  max abs "
              f"{diff:.2e}  kernel {row['ms']:.4f} ms  "
              f"plain {row['plain_ms']:.4f} ms  library "
              f"{row['library_ms']} ms (SDPA {row['library_backend']})  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
    return rows


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def library_attention_ms(q, k, v, causal, window, mask):
    """The yardstick: ``scaled_dot_product_attention`` on the same
    inputs (no mask where the call is unmasked, the fused causal form
    where no window asks for a mask), run by the first of
    ``SDPA_BACKENDS`` that takes the call; returns its ms and that
    backend's name."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel
    args = [tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))]
    if window:
        kw = {"attn_mask": mask}
    else:
        kw = {"is_causal": causal}

    def call(x, y, z):
        return F.scaled_dot_product_attention(x, y, z, enable_gqa=True, **kw)

    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel(backend):
                    call(*args[0])
                    torch.cuda.synchronize()
            except RuntimeError:
                continue
            with sdpa_kernel(backend):
                return time_ms(call, args), name.lower()
    return None, None


def off_grid(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def run_wkv(dev, gen):
    from repro_torch.kernels.tolerance import (allowance, check_wkv,
                                               wkv_inputs,
                                               wkv_planted_faults)
    from repro_torch.kernels.wkv6 import ops
    rows = []
    for label, B, S, H, K, chunk, dt, decay, main in wkv_cases():
        args = wkv_inputs(B, S, H, K, dt, decay, gen, dev)
        aligned = label != "unaligned bf16"
        if not aligned:
            args = tuple(off_grid(t) for t in args)
        route = ops.dispatch(S, K, dt, aligned, chunk)
        before = dict(ops.wkv.paths)
        got = ops.wkv(*args, chunk=chunk)
        torch.cuda.synchronize()
        path = launched_path(ops.wkv.paths, before)
        want_path = ("tensor_core" if dt == torch.bfloat16 and aligned
                     else "fma")
        if path != route["path"] or path != want_path:
            fail(f"wkv6 {label}: launched {path}, dispatch says "
                 f"{route['path']}, expected {want_path}")
        if main:
            again = ops.wkv(*args, chunk=chunk)
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                fail(f"wkv6 {label}: two runs differ")
        want = ops.wkv_plain(*args)
        ratio, diff = check_wkv(got, want, dt)
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
                and ratio < 1):
            fail(f"wkv6 {label}: error at {ratio:.3f} of its allowance")
        # the carry fault at the boundary between the first two blocks'
        # chunks and, where the cluster walks groups, between two groups
        group = (route["rows"] * route["cluster"] if route["groups"] > 1
                 else None)
        faults = {name: check_wkv(f, want, dt)[0]
                  for name, f in wkv_planted_faults(
                      lambda *a: ops.wkv(*a, chunk=chunk), *args,
                      route["rows"], group).items()}
        for name, fault in faults.items():
            if not fault > 1:
                fail(f"wkv6 {label}: the check misses '{name}' "
                     f"({fault:.3f} of its allowance)")
        atol_frac, rtol = allowance(dt, "wkv6")
        row = {"kernel": "wkv6", "case": label, "shape": [B, S, H, K],
               "chunk_asked": chunk, "chunk": route["rows"],
               "path": path, "cluster": route["cluster"],
               "groups": route["groups"], "dtype": str(dt),
               "deterministic": main or None, "decay": decay,
               "err_ratio": ratio, "fault_ratio": min(faults.values()),
               "faults": faults, "max_abs_err": diff, "rtol": rtol,
               "atol_frac": atol_frac, "main_path": main}
        # distinct copies that together exceed L2, as the main path finds
        # its inputs
        nbytes = sum(t.numel() * t.element_size() for t in args) \
            + got[0].numel() * got[0].element_size() \
            + got[1].numel() * got[1].element_size()
        copies = max(1, min(8, math.ceil(2 * L2_BYTES / nbytes)))
        copy = torch.clone if aligned else off_grid
        sets = [args] + [tuple(copy(t) for t in args)
                         for _ in range(copies - 1)]
        row["ms"] = time_ms(lambda *a: ops.wkv(*a, chunk=chunk), sets)
        row["plain_ms"] = time_ms(lambda *a: ops.wkv_plain(*a), sets[:1],
                                  min_reps=2)
        row["library_ms"] = None      # no one PyTorch call computes WKV6
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 4 * B * S * H * K * K, torch.float32)
        if main:
            row["step_shares"] = wkv_step_shares(args, route)
        del sets
        rows.append(row)
        print(f"  wkv6 {label:20s} B{B} S{S} H{H} K{K} {path}, "
              f"{route['rows']} rows a block, cluster {route['cluster']} x "
              f"{route['groups']} groups, {str(dt)[6:]} {decay} decay: "
              f"err {ratio:.3f} of allowance (faults " + ", ".join(
                  f"{n} {f:.1f}" for n, f in faults.items())
              + f")  max abs {diff:.2e}  kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        if main:
            print("    wkv6 step shares of a block's cycles (clock64, "
                  "WKV6_STEP_CLOCKS build): " + ", ".join(
                      f"{n} {v:.3f}" for n, v in row["step_shares"].items()),
                  flush=True)
    return rows


WKV_STEPS = ("w landed", "scan, r k v landed", "exp2(total), k', diagonal",
             "off-diagonal A", "r exp2(e), kd", "dS (warp 0)",
             "first cluster barrier", "fold", "second cluster barrier",
             "y")


def wkv_step_shares(args, route):
    """Each step's share of the cycles of the ``tensor_core`` kernel's
    blocks on ``args``, and the cycles of a block, from the
    ``wkv6_steps`` build (thread 0 of each block reads clock64 as each
    step ends).  Launched through that library's own C entry: the
    wrapper's counts do not move."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import ops
    lib = _build.load("wkv6_steps")
    launch = lib.wkv6_tc_launch
    launch.argtypes = ops.ENTRIES["tensor_core"][1]
    launch.restype = ctypes.c_int
    read = lib.wkv6_step_clocks
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    r = args[0]
    B, S, H, K = r.shape
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    counts = (ctypes.c_ulonglong * (len(WKV_STEPS) + 1))()
    for _ in range(2):          # the first run warms up
        if read(counts):
            fail("wkv6 step clocks: read failed")
        err = launch(*(t.data_ptr() for t in args), y.data_ptr(),
                     state.data_ptr(), B, S, H, K, route["rows"],
                     torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            fail(f"wkv6 step clocks: launch failed ({err})")
    if read(counts):
        fail("wkv6 step clocks: read failed")
    total = sum(counts[:len(WKV_STEPS)])
    shares = {n: counts[i] / total for i, n in enumerate(WKV_STEPS)}
    shares["cycles per block"] = total / counts[len(WKV_STEPS)]
    return shares


def phase_kernels(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = run_matmul(dev, gen) + run_flash(dev, gen) + run_wkv(dev, gen)
    print(f"phase 3 kernels: {len(rows)} cases within tolerance",
          flush=True)
    return rows


# ------------------------------------------------------------- model

# the reduced models of phase 4: arch -> layers (gemma3: one unit of its
# five local and one global layer, its window cut below the prompt;
# zamba2: two units, so both tied blocks run, and a tail of three;
# whisper: two decoder and two encoder layers)
MODELS = {"qwen2-0.5b": 2, "rwkv6-1.6b": 2, "gemma3-12b": 6,
          "qwen3-moe-235b-a22b": 2, "llama4-maverick-400b-a17b": 2,
          "zamba2-7b": 15, "whisper-base": 2, "pixtral-12b": 2}
REDUCED_WINDOW = 16
# phase 4's whisper frames are longer than its prompt (Sq != Sk in the
# cross-attention); its pixtral replaces the first 16 token embeddings
REDUCED_FRAMES = 96
REDUCED_PATCHES = 16


def phase_model(dev, arch):
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_items, tree_map

    cfg = reduce_config(get_config(arch), layers=MODELS[arch], d_model=128,
                        vocab=512)
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.attention and cfg.attention.sliding_window:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, sliding_window=REDUCED_WINDOW))
    B, P, G = 2, 64, 8
    opts = lm.RunOptions(chunk_q=32, chunk_kv=32, cache_len=P + G,
                         remat=False)
    cpu_params = lm.init_params(cfg, seed=0, device="cpu")
    # the RWKV bonus and token-shift mixes start at zero: make them count
    gen = torch.Generator().manual_seed(2)
    for path, leaf in tree_items(cpu_params):
        if path.rsplit("/", 1)[-1] in ("u", "maa_x", "maa_rkvwg", "maa_k",
                                       "maa_r"):
            leaf.copy_(0.3 * torch.randn(leaf.shape, generator=gen))
    a = cfg.attention
    if "shared" in cpu_params:
        # the init rule takes the head count as the tied blocks' q/k
        # fan-in; at the fan-in of their 2d inputs their softmax is not
        # one-hot up to near ties, which fp32 rounding would decide
        for name in ("wq", "wk"):
            cpu_params["shared"]["attn"][name].mul_(
                math.sqrt(a.num_heads / (2 * cfg.d_model)))
    if cfg.family == "encdec":
        # the same for whisper's unmasked encoder and cross-attention:
        # q/k at the fan-in of their d inputs
        for blk in (cpu_params["encoder"]["stack"]["pos0"]["attn"],
                    cpu_params["stage0"]["pos0"]["self"],
                    cpu_params["stage0"]["pos0"]["cross"]):
            for name in ("wq", "wk"):
                blk[name].mul_(math.sqrt(a.num_heads / cfg.d_model))
    np_params = tree_map(lambda t: t.numpy(), cpu_params)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P),
                                     generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, REDUCED_FRAMES, cfg.d_model),
                                      generator=gen)
    if cfg.frontend.kind == "patches" and cfg.frontend.num_positions:
        batch["patch_embeds"] = 0.02 * torch.randn(
            (B, REDUCED_PATCHES, cfg.d_model), generator=gen)
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        params = convert.params_from_numpy(cfg, np_params, d)
        logits, cache = lm.prefill(
            cfg, params, {k: v.to(d) for k, v in batch.items()}, opts)
        first = logits.cpu()
        toks = []
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
        for i in range(G):
            logits, cache = lm.decode_step(cfg, params, cache, tok, P + i,
                                           opts)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
            toks.append(tok.cpu())
        runs[name] = (first, torch.stack(toks, 1))
    rel, _ = rel_err(runs["cuda"][0][:, :cfg.vocab_size],
                     runs["cpu"][0][:, :cfg.vocab_size])
    same = torch.equal(runs["cuda"][1], runs["cpu"][1])
    fed = ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items())
    print(f"phase 4 model: reduced {arch} fp32 ({fed}) card vs CPU: "
          f"prefill logits rel err {rel:.2e} (tol {MODEL_TOL:.0e}); {G} "
          f"greedy tokens identical: {same}", flush=True)
    if not rel < MODEL_TOL:
        fail("reduced model logits disagree between card and CPU")
    if not same:
        fail(f"greedy tokens differ: card {runs['cuda'][1].tolist()} "
             f"cpu {runs['cpu'][1].tolist()}")
    return {"layers": MODELS[arch], "fed": fed, "logits_rel_err": rel,
            "tokens_identical": same}


MOE_SERVE = ["--arch", "qwen3-moe-235b-a22b", "--dtype", "float32",
             "--gen", "8", "--deadline-ms", "10000"]


def phase_moe_serve():
    """Reduced qwen3-moe-235b-a22b (2 layers of 4 experts, top 2, fp32)
    through ``serve.main`` on the card and on the CPU: a reduced serve
    draws its weights and prompt on the CPU, so both serve the same
    model.  The card's decode steps replay one captured CUDA graph with
    the MoE routing in it; the tokens must be the CPU's."""
    from repro_torch.launch import serve
    res = {}
    for device in ("cuda", "cpu"):
        res[device] = serve.main(MOE_SERVE + ["--device", device])
    card, cpu = (np.stack(res[d]["tokens"], 1) for d in ("cuda", "cpu"))
    replayed = res["cuda"]["replayed_launches"]["spm_matmul"]
    print(f"phase 4 moe serve: repro_torch.launch.serve "
          f"{' '.join(MOE_SERVE)}: card tokens {card.tolist()}, CPU "
          f"{cpu.tolist()}; spm_matmul launched by the decode graph's "
          f"replays {replayed}", flush=True)
    if card.shape != cpu.shape or not np.array_equal(card, cpu):
        fail("the reduced MoE serve's tokens differ between card and CPU")
    if replayed != (2 * 4 + 1) * card.shape[1]:
        fail(f"the MoE decode graph's replays launched {replayed} "
             f"spm_matmul, expected 9 per step")
    prefill = res["cuda"]["prefill_launches"]["spm_matmul"]
    print(f"phase 4 moe serve: spm_matmul launched by the prefill graph's "
          f"replay {prefill}", flush=True)
    if prefill != 2 * 4 + 1:
        fail(f"the MoE prefill graph's replay launched {prefill} "
             f"spm_matmul, expected 9")


# ------------------------------------------------------------- serve

# per served arch: its prompt, its vocabulary, the kernels its path must
# launch, the wrapper launches one prefill must make (one per layer, for
# spm_matmul one per product) and the spm_matmul launches one decode step
# must make (products per layer x layers + logits)
SERVES = {
    "qwen2-0.5b": {"prompt": 256, "vocab": 151_936,
                   "kernels": ("spm_matmul", "flash_attention"),
                   "per_prefill": {"spm_matmul": 7 * 24 + 1,
                                   "flash_attention": 24},
                   "mm_per_step": 7 * 24 + 1},
    "rwkv6-1.6b": {"prompt": 256, "vocab": 65_536,
                   "kernels": ("spm_matmul", "wkv6"),
                   "per_prefill": {"spm_matmul": 16 * 24 + 1, "wkv6": 24},
                   "mm_per_step": 16 * 24 + 1},
    # prompt 2048: twice the local layers' window of 1024
    "gemma3-12b": {"prompt": 2048, "vocab": 262_144,
                   "kernels": ("spm_matmul", "flash_attention"),
                   "per_prefill": {"spm_matmul": 7 * 48 + 1,
                                   "flash_attention": 48},
                   "mm_per_step": 7 * 48 + 1},
    # prompt 512: two SSD chunks of 256, so the inter-chunk state carry
    # runs; 81 mamba layers of 2 products, 13 tied-block applications of
    # 6 (and one flash launch each)
    "zamba2-7b": {"prompt": 512, "vocab": 32_000,
                  "kernels": ("spm_matmul", "flash_attention"),
                  "per_prefill": {"spm_matmul": 81 * 2 + 13 * 6 + 1,
                                  "flash_attention": 13},
                  "mm_per_step": 81 * 2 + 13 * 6 + 1},
    # prompt 1536: the config's cross_kv_len; frames as long as the
    # prompt.  Prefill: 6 encoder layers of 6 products, 6 decoder layers
    # of 10 (self q/k/v/o, cross q/k/v/o, FFN up/down), one flash launch
    # each for the encoder, the decoder self and the cross blocks; decode:
    # 8 a layer (the cross k/v are prefill-only).  Vocab 51,865 padded to
    # 51,968: the padded logits must stay masked
    "whisper-base": {"prompt": 1536, "vocab": 51_865,
                     "kernels": ("spm_matmul", "flash_attention"),
                     "per_prefill": {"spm_matmul": 6 * 6 + 6 * 10 + 1,
                                     "flash_attention": 3 * 6},
                     "mm_per_step": 8 * 6 + 1},
    # prompt 1024: the stub's num_positions (the serve feeds no patches,
    # so the dense path serves); head dim 128
    "pixtral-12b": {"prompt": 1024, "vocab": 131_072,
                    "kernels": ("spm_matmul", "flash_attention"),
                    "per_prefill": {"spm_matmul": 7 * 40 + 1,
                                    "flash_attention": 40},
                    "mm_per_step": 7 * 40 + 1},
}


OUT_DIR = ROOT / "chiprun_out"
# qwen2-0.5b's serve writes its REPRO_TRACE here
SERVE_TRACE = OUT_DIR / "serve_trace_qwen2-0.5b.json"
G = 32
# prefill graph replays timed per served arch, greedy tokens compared
# between the graphs and eager calls
PREFILL_REPLAYS = {"qwen2-0.5b": 10, "rwkv6-1.6b": 10, "gemma3-12b": 3,
                   "zamba2-7b": 3, "whisper-base": 10, "pixtral-12b": 3}
PARITY_TOKENS = 8


def serve_argv(arch):
    return ["--arch", arch, "--full", "--batch", "4", "--prompt-len",
            str(SERVES[arch]["prompt"]), "--gen", str(G), "--device",
            "cuda"]


def release():
    """Hand the last phase's device memory back before the next."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(arch):
    from repro_torch.launch import serve

    want = SERVES[arch]
    argv = serve_argv(arch)
    env = f"REPRO_TRACE={SERVE_TRACE} " if arch == "qwen2-0.5b" else ""
    print(f"phase 5 serve: {env}repro_torch.launch.serve "
          f"{' '.join(argv)}", flush=True)
    if env:
        SERVE_TRACE.unlink(missing_ok=True)
        os.environ["REPRO_TRACE"] = str(SERVE_TRACE)
    reset_launches()
    try:
        res = serve.main(argv)
    finally:
        os.environ.pop("REPRO_TRACE", None)
    launches = serve.launch_counts()
    paths = path_counts()
    replayed = res["replayed_launches"]
    print(f"phase 5 serve {arch}: wrapper launches {launches}; launched "
          f"by the timed prefill graph's replay {res['prefill_launches']}; "
          f"by the timed decode graph's replays {replayed}", flush=True)
    for name in want["kernels"]:
        if launches[name] == 0:
            fail(f"{name} never launched on the {arch} path")
    for name, n in want["per_prefill"].items():
        if res["prefill_launches"][name] != n:
            fail(f"{arch}: the timed prefill's replay launched "
                 f"{res['prefill_launches'][name]} {name}, expected {n}")
    if replayed["spm_matmul"] != want["mm_per_step"] * G:
        fail(f"{arch}: the timed decode steps' replays launched "
             f"{replayed['spm_matmul']} spm_matmul, expected "
             f"{want['mm_per_step']} x {G}")
    check_serve_paths(arch, launches, paths, res["plan"])
    toks = res["tokens"]
    if [t.shape for t in toks] != [(4,)] * G:
        fail(f"expected 4x{G} generated tokens, got steps of "
             f"{[t.shape[0] for t in toks]} (deadline shed)")
    toks = np.stack(toks, 1)
    if not ((toks >= 0) & (toks < want["vocab"])).all():
        fail(f"a generated token is outside [0, {want['vocab']})")
    print(f"phase 5 serve {arch}: ok, {toks.shape[0]}x{toks.shape[1]} "
          f"tokens in [0, {want['vocab']}), prefill "
          f"{res['prefill_s'] * 1e3:.3f} ms (one graph replay)", flush=True)
    shares = serve_flop_shares(arch, res)
    print(f"phase 5 serve {arch}: model FLOPs as a share of 989 TFLOP/s: "
          f"the reference's analysis.flops.model_flops (2 x active params x "
          f"tokens) prefill {shares['reference_prefill']:.4f}, decode "
          f"step (median) {shares['reference_decode']:.4f}; "
          f"launch/train.py's dense-decoder count (params x tokens + "
          f"causal attention) over 3, the forward's, prefill "
          f"{shares['port_prefill'] or '-'}", flush=True)
    return launches, dict(res, paths=paths, flop_shares=shares)


def serve_flop_shares(arch, res):
    """A served model's prefill and median decode step as shares of the
    bf16 peak under the reference's ``model_flops`` (batch 4, the
    prompt), and the prefill under the forward third of
    ``launch/train.py``'s count for a dense decoder (it counts every
    layer's attention and every prompt token; None for the other
    families)."""
    import dataclasses
    from repro_torch.analysis.flops import model_flops
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import train
    cfg, P = get_config(arch), SERVES[arch]["prompt"]
    peak = PEAK_FLOPS[torch.bfloat16]
    pre = dataclasses.replace(SHAPES["prefill_32k"], global_batch=4,
                              seq_len=P)
    dec = dataclasses.replace(SHAPES["decode_32k"], global_batch=4)
    step = float(np.median(res["decode_s"]))
    return {"reference_prefill": model_flops(cfg, pre)
            / res["prefill_s"] / peak,
            "reference_decode": model_flops(cfg, dec) / step / peak,
            "port_prefill": round(train.model_flops(cfg, 4, P) / 3
                                  / res["prefill_s"] / peak, 4)
            if cfg.family in ("dense", "vlm") else None}


def phase_capture(dev, arch, timing=True, phase=5):
    """The serve's model, weights and prompt again (``serve.setup``,
    seed 0, the plan the serve resolves) through
    ``serve.compile_step_fns``: the prefill graph's logits against an
    eager ``lm.prefill``'s (bit for bit), greedy tokens through the two
    graphs against eager calls, then (``timing``) the prefill graph's
    replays timed by CUDA events, and the traces of phase 6."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(serve_argv(arch))
    cfg, _, _, opts, params, batch = serve.setup(args, dev)
    P, V = args.prompt_len, cfg.vocab_size

    def greedy(logits, stepper):
        toks = [torch.argmax(logits[:, :V], dim=-1)]
        for i in range(PARITY_TOKENS - 1):
            toks.append(torch.argmax(stepper(toks[-1], P + i)[:, :V],
                                     dim=-1))
        return torch.stack(toks, 1).cpu()

    prefill_fn, step = serve.compile_step_fns(cfg, params, batch, opts, P)
    logits, _ = prefill_fn(batch)
    captured = logits.clone()
    graph_toks = greedy(captured, step)
    eager, cache = lm.prefill(cfg, params, batch, opts)
    eager_toks = greedy(eager, lambda t, p: lm.decode_step(
        cfg, params, cache, t, p, opts)[0])
    same = torch.equal(captured, eager)
    diff = (captured - eager).abs().max().item()
    print(f"phase {phase} capture {arch}: prefill graph "
          f"({prefill_fn.captured} "
          f"launches a replay) against eager lm.prefill: logits "
          f"bit-identical {same} (max abs diff {diff:.3e}); "
          f"{PARITY_TOKENS} greedy tokens through the graphs "
          f"{graph_toks.tolist()}, eager {eager_toks.tolist()}",
          flush=True)
    if not same:
        fail(f"{arch}: the captured prefill's logits differ from the "
             f"eager prefill's")
    if not torch.equal(graph_toks, eager_toks):
        fail(f"{arch}: greedy tokens through the graphs differ from "
             f"eager ones")
    if cfg.padded_vocab != V:
        check_padded_logits(arch, cfg, captured,
                            step(graph_toks[:, -1].to(dev),
                                 P + PARITY_TOKENS - 1))
    del eager, cache
    release()
    if not timing:
        return {}

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replay_ms = []
    for _ in range(PREFILL_REPLAYS[arch]):
        start.record()
        prefill_fn(batch)
        end.record()
        torch.cuda.synchronize()
        replay_ms.append(start.elapsed_time(end))
    tok = graph_toks[:, -1].to(dev)
    out = {"prefill_replay_ms": replay_ms,
           "decode_trace": trace_replays(
               f"{arch} decode step (graph replay, batch 4, {P}-token "
               f"prompt)", lambda i: step(tok, P + PARITY_TOKENS + i), 3)}
    if arch in ("gemma3-12b", "zamba2-7b"):
        out["prefill_trace"] = trace_replays(
            f"{arch} prefill (graph replay, 4 x {P} tokens)",
            lambda i: prefill_fn(batch), 1)
    return out


def check_padded_logits(arch, cfg, prefill_logits, decode_logits):
    """A padded vocabulary's tail, after the prefill replay and after a
    decode replay: every padded logit exactly -1e30, and no argmax over
    the whole padded row there."""
    V = cfg.vocab_size
    for what, logits in (("prefill", prefill_logits),
                         ("decode", decode_logits)):
        tail = logits[:, V:]
        masked = bool((tail == -1e30).all())
        top = int(torch.argmax(logits, dim=-1).max())
        print(f"phase 5 capture {arch}: {what} replay's padded logits "
              f"[:, {V}:{cfg.padded_vocab}] all -1e30 {masked}; largest "
              f"argmax over the padded row {top}", flush=True)
        if not masked or top >= V:
            fail(f"{arch}: the {what} replay's padded logits are not "
                 f"masked (argmax {top}, vocab {V})")


# kernel families of a trace: the first pattern a kernel's name contains
# names its family
TRACE_FAMILIES = (
    ("spm_matmul", ("splitk_decode_kernel", "wgmma_gemm_kernel",
                    "spm_matmul_kernel")),
    ("flash_attention", ("flash_fwd",)),
    ("wkv6", ("wkv6",)),
    ("cuBLAS products (decode attention, SSD einsums)",
     ("gemm", "gemv", "cutlass", "xmma", "nvjet")),
    ("copies (contiguous, index_copy, cat)", ("copy", "index", "cat",
                                              "Cat")),
    ("softmax", ("softmax", "Softmax", "SoftMax")),
    ("norms", ("rms", "norm", "Norm")),
    ("elementwise and reductions", ("elementwise", "reduce", "Reduce")),
)


def trace_replays(what, run, n, phase=6, families=TRACE_FAMILIES):
    """Where a graph replay's device time goes: ``run(i)`` replays it.
    After one warm-up call, ``n`` calls between CUDA events give the
    replay's time; ``n`` more under ``torch.profiler`` give each
    kernel's device time, summed by family (``TRACE_FAMILIES``), per
    replay.  The device's busy share is the kernels' time over the
    replay's."""
    from torch.profiler import ProfilerActivity, profile

    run(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        run(1 + i)
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            run(1 + n + i)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
    patterns = families
    families = dict.fromkeys([f for f, _ in patterns] + ["other"], 0.0)
    for name, ms in by_name.items():
        fam = next((f for f, pats in patterns
                    if any(p in name for p in pats)), "other")
        families[fam] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase {phase} trace: {what}: {replay_ms:.3f} ms a replay, kernels "
          f"{busy:.3f} ms (device busy {busy / replay_ms:.3f}); by family: "
          + ", ".join(f"{f} {ms:.3f}" for f, ms in families.items()
                      if ms), flush=True)
    for name, ms in top:
        print(f"    {ms:8.4f} ms  {name[:110]}")
    if busy == 0:
        fail(f"the profiler saw no kernel of the {what}")
    return {"replay_ms": replay_ms, "kernel_ms": busy,
            "busy_share": busy / replay_ms, "families_ms": families,
            "top_kernels_ms": dict(top)}


def phase_predictability(serves, captures):
    """The jitter statistics of every serve's decode steps (host clock,
    with the WCET margin) and prefill graph replays (CUDA events), as a
    schema-v1 report the port's validator must accept; then the qwen2
    serve's REPRO_TRACE file."""
    from repro_torch.obs import jitter_stats, make_report, validate_report

    rows = []
    for arch, (_, res) in serves.items():
        P = SERVES[arch]["prompt"]
        decode = jitter_stats([t * 1e6 for t in res["decode_s"]],
                              wcet_bound=res["wcet_s"] * 1e6)
        prefill = jitter_stats([ms * 1e3 for ms in
                                captures[arch]["prefill_replay_ms"]])
        for what, st, src in (("decode", decode,
                               f"{G} steps, host clock"),
                              ("prefill", prefill,
                               f"{prefill.n} graph replays, CUDA events")):
            margin = ("" if st.wcet_margin is None
                      else f" wcet_margin {st.wcet_margin:.4f} (bound "
                           f"{res['wcet_s'] * 1e3:.4f} ms)")
            print(f"phase 7 predictability {arch} {what} ({src}): median "
                  f"{st.median / 1e3:.4f} ms p99 {st.p99 / 1e3:.4f} ms "
                  f"spread {st.spread / 1e3:.4f} ms cov {st.cov:.4f}"
                  + margin, flush=True)
            rows.append({"name": f"serve/{arch}/{what}",
                         "us_per_call": st.median,
                         "derived": f"batch=4 prompt={P} gen={G} bf16 "
                                    f"{src}",
                         "jitter": st.as_dict()})
    report = make_report(rows)
    errs = validate_report(report)
    path = OUT_DIR / "chip_smoke_report.json"
    path.write_text(json.dumps(report, indent=1))
    print(f"phase 7 predictability: schema-v{report['schema_version']} "
          f"report of {len(rows)} rows -> {path.relative_to(ROOT)} "
          f"(fingerprint gpu {report['hw_fingerprint']['gpu']!r}, power "
          f"limit {report['hw_fingerprint']['power_limit_w']} W); "
          f"validate_report: {errs}", flush=True)
    if errs:
        fail(f"the report does not validate: {errs}")
    doc = json.loads(SERVE_TRACE.read_text())
    names = [(e["ph"], e["name"]) for e in doc["traceEvents"]]
    counts = {"prefill spans": names.count(("X", "prefill")),
              "decode spans": sum(ph == "X" and n.startswith("decode")
                                  for ph, n in names),
              "step_ms counters": names.count(("C", "step_ms"))}
    print(f"phase 7 predictability: {SERVE_TRACE.relative_to(ROOT)} holds "
          f"{counts}", flush=True)
    if counts != {"prefill spans": 1, "decode spans": G,
                  "step_ms counters": G}:
        fail(f"qwen2's REPRO_TRACE file holds {counts}, expected 1 "
             f"prefill span, {G} decode spans and {G} step_ms counters")
    return report


# ------------------------------------------------------------- tune

TUNE_CACHE = OUT_DIR / "tuning_plans.json"
TUNE_MODEL = ["--model", "qwen2-0.5b", "--layers", "0", "--shape",
              "4x256x32", "--dtype", "bfloat16"]
TUNE_REPS = 5
# plans measured per kernel shape after the analytic pruning: every
# decode candidate (the model cannot tell their K staging apart)
TUNE_MAX_CANDIDATES = 6


def tune_cases():
    """(label, kernel, problem): main-path shapes, bf16."""
    from repro_torch.tuning import (AttentionProblem, MatmulProblem,
                                    WkvProblem)
    bf = "bfloat16"
    return (
        ("qwen2 decode gate/up", "spm_matmul",
         MatmulProblem(4, 896, 4864, bf)),
        ("gemma3 decode down", "spm_matmul",
         MatmulProblem(4, 15360, 3840, bf)),
        ("qwen2 prefill gate/up", "spm_matmul",
         MatmulProblem(1024, 896, 4864, bf)),
        ("gemma3 logits", "spm_matmul",
         MatmulProblem(4, 3840, 262_144, bf, trans_b=True)),
        ("qwen2 flash prefill", "flash_attention",
         AttentionProblem(4, 256, 256, 14, 2, 64, dtype=bf)),
        ("rwkv6 wkv6 prefill", "wkv6", WkvProblem(4, 256, 32, 64, bf)),
    )


def launch_text(kernel, problem, plan):
    """The path (and split, or rows per block) a plan launches."""
    from repro_torch.tuning.candidates import matmul_launch, wkv_launch
    if kernel == "spm_matmul":
        launch = matmul_launch(problem, plan)
        t = launch["tile"]
        return (f"{launch['path']} x{launch['splits']} tile "
                f"{t['bm']}x{t['bn']} K staged {t['bkc']}")
    if kernel == "wkv6":
        launch = wkv_launch(problem, plan)
        return (f"{launch['path']}, {launch['rows']} rows a block, "
                f"cluster {launch['cluster']} x {launch['groups']} groups")
    return "tensor_core 64x64"


def steer_check(dev):
    """The wrapper on the card takes a cached plan: a cache holding a
    tiled plan for qwen2's decode gate/up moves an unpinned call there
    from split-K (and the result stays within its allowance); with
    ``REPRO_AUTOTUNE=0`` the same call launches split-K again."""
    from repro_torch import tuning
    from repro_torch.kernels.spm_matmul import ops
    from repro_torch.kernels.tolerance import check
    tuned = tuning.active_cache()
    problem = tuning.MatmulProblem(4, 896, 4864, "bfloat16")
    steer = tuning.PlanCache(str(OUT_DIR / "steer_plans.json"))
    steer.put(tuning.cache_key("spm_matmul", problem),
              {"bm": 16, "bn": 64, "bk": 256})
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(4, 896, generator=gen, device=dev).bfloat16()
    b = torch.randn(896, 4864, generator=gen, device=dev).bfloat16()
    want = ops.matmul_plain(a, b, torch.bfloat16)
    paths = []
    for autotune in ("1", "0"):
        os.environ["REPRO_AUTOTUNE"] = autotune
        tuning.reset(steer)
        before = dict(ops.matmul.paths)
        got = ops.matmul(a, b)
        torch.cuda.synchronize()
        paths.append(launched_path(ops.matmul.paths, before))
        ratio, _ = check(got, want, torch.bfloat16)
        if not ratio < 1:
            fail(f"steered spm_matmul: error at {ratio:.3f} of its "
                 f"allowance")
    os.environ["REPRO_AUTOTUNE"] = "1"
    tuning.reset(tuned)
    print(f"phase 8 tune: an unpinned 4x896x4864 call with a cached "
          f"tiled plan launched {paths[0]}, with REPRO_AUTOTUNE=0 "
          f"{paths[1]}", flush=True)
    if paths != ["tiled", "splitk"]:
        fail(f"the wrapper did not follow the cache: {paths}")


def phase_tune(dev, smi):
    """Phase 8 (see the module note); returns its numbers."""
    from repro_torch import tuning
    from repro_torch.launch import serve
    from repro_torch.launch import tune as tune_cli
    from repro_torch.obs import TraceRecorder

    TUNE_CACHE.unlink(missing_ok=True)
    os.environ["REPRO_PLAN_CACHE"] = str(TUNE_CACHE)
    os.environ["REPRO_AUTOTUNE"] = "1"
    tuning.reset()
    t0 = time.monotonic()
    cold = TraceRecorder()
    rows = []
    for label, kernel, problem in tune_cases():
        res = tuning.tune(kernel, problem, reps=TUNE_REPS,
                          max_candidates=TUNE_MAX_CANDIDATES, trace=cold)
        errs = res.err_ratios
        if len(errs) != res.pruned_to or not all(r < 1 for r in
                                                 errs.values()):
            fail(f"tune {label}: measured {res.pruned_to} plans, held "
                 f"{errs} to the plain version")
        w, d = res.stats, res.default_stats
        print(f"phase 8 tune {label} ({kernel} {problem.sig}): "
              f"{res.candidates} candidates, {res.feasible} feasible, "
              f"{res.pruned_to} measured (errors as shares of the "
              f"allowance {', '.join(f'{k} {v:.3f}' for k, v in errs.items())}"
              f"); winner {tuning.plan_sig(res.plan)}: "
              f"{launch_text(kernel, problem, res.plan)}, p99 {w.p99:.2f} "
              f"us cov {w.cov:.4f}; default "
              f"{tuning.plan_sig(res.default_plan)}: "
              f"{launch_text(kernel, problem, res.default_plan)}, p99 "
              f"{d.p99:.2f} us cov {d.cov:.4f} ({smi})", flush=True)
        for sig, st in res.results.items():
            print(f"    {sig:24s} median {st.median:10.2f} us  p99 "
                  f"{st.p99:10.2f} us  cov {st.cov:.4f}")
        rows.append({"case": label, "kernel": kernel, "shape": problem.sig,
                     "candidates": res.candidates, "feasible": res.feasible,
                     "measured": res.pruned_to, "plan": res.plan,
                     "launch": launch_text(kernel, problem, res.plan),
                     "default_plan": res.default_plan,
                     "stats": w.as_dict(), "default_stats": d.as_dict(),
                     "results": {k: v.as_dict()
                                 for k, v in res.results.items()},
                     "err_ratios": errs})
    spans = tuning.measurement_count(cold)
    cold_s = time.monotonic() - t0
    warm = TraceRecorder()
    for (label, kernel, problem), row in zip(tune_cases(), rows):
        res = tuning.tune(kernel, problem, trace=warm)
        if res.source != "cache" or res.plan != row["plan"]:
            fail(f"tune {label}: the warm run gave {res.plan} from "
                 f"{res.source}, the cold one {row['plan']}")
    print(f"phase 8 tune: cold {spans} measurement spans in {cold_s:.1f} "
          f"s; warm {tuning.measurement_count(warm)} spans, same plans",
          flush=True)
    if tuning.measurement_count(warm):
        fail("the warm tuning run measured again")
    steer_check(dev)

    print(f"phase 8 tune: python -m repro_torch.launch.tune "
          f"{' '.join(TUNE_MODEL)}", flush=True)
    out = tune_cli.run(TUNE_MODEL)
    mres = out["results"][0]
    if mres.source != "measured" or mres.pruned_to != 2 \
            or out["spans"] != 2 * TUNE_REPS:
        fail(f"model tuning measured {mres.pruned_to} plans in "
             f"{out['spans']} spans ({mres.source}), expected the two "
             f"decode programs")
    release()

    print(f"phase 8 serve on the tuned cache: repro_torch.launch.serve "
          f"{' '.join(serve_argv('qwen2-0.5b'))}", flush=True)
    reset_launches()
    res = serve.main(serve_argv("qwen2-0.5b"))
    launches, paths = serve.launch_counts(), path_counts()
    want = SERVES["qwen2-0.5b"]
    print(f"phase 8 serve qwen2-0.5b: plan [{res['plan_source']}] "
          f"{res['plan']} (tuned {mres.plan}); wrapper launches "
          f"{launches}", flush=True)
    if "cache" not in res["plan_source"] or res["plan"] != mres.plan:
        fail(f"the serve ran {res['plan']} from {res['plan_source']}, "
             f"not the tuned plan {mres.plan} from the cache")
    if res["prefill_launches"] != {**dict.fromkeys(launches, 0),
                                   **want["per_prefill"]} \
            or res["replayed_launches"]["spm_matmul"] \
            != want["mm_per_step"] * G:
        fail(f"the tuned serve's replays launched "
             f"{res['prefill_launches']} and {res['replayed_launches']}")
    check_serve_paths("qwen2-0.5b", launches, paths, res["plan"],
                      tuned=True)
    if len(res["tokens"]) != G:
        fail("the tuned serve did not generate every token")
    release()
    phase_capture(dev, "qwen2-0.5b", timing=False, phase=8)
    m_def, m_tuned = mres.default_stats, mres.stats
    return {"kernels": rows, "cold_spans": spans, "cold_s": cold_s,
            "model": {"plan": mres.plan, "default_plan": mres.default_plan,
                      "candidates": mres.candidates,
                      "measured": mres.pruned_to,
                      "results": {k: dict(v.as_dict(),
                                          us_per_token=tuning.us_per_token(
                                              v, mres.problem))
                                  for k, v in mres.results.items()},
                      "us_per_token": tuning.us_per_token(m_tuned,
                                                          mres.problem),
                      "default_us_per_token": tuning.us_per_token(
                          m_def, mres.problem),
                      "stats": m_tuned.as_dict(),
                      "default_stats": m_def.as_dict()},
            "serve": {"plan_source": res["plan_source"], "plan": res["plan"],
                      "paths": paths, "launches": launches,
                      "decode_ms": [t * 1e3 for t in res["decode_s"]],
                      "prefill_ms": res["prefill_s"] * 1e3,
                      "jitter": res["jitter"]}}


def check_serve_paths(arch, launches, paths, plan, tuned=False):
    """A serve's wrappers launch for exactly two prefills and two decode
    steps: the eager warm-up before each graph's capture and the
    capture; the timed prefill and steps are replays and pass no
    wrapper.  Untuned, every decode product but the logits took the
    split-K path, every prefill product but the logits (taken at the
    last position, M = batch) the wgmma path, and flash_attention and
    wkv6 their tensor-core kernels; the paths ``ops.launch_plan`` gives
    each product under the served plan's pins must say the same.  On a
    tuned cache (``tuned``) the paths must be those ``launch_plan``
    gives, the cached plans' pins in them."""
    want = SERVES[arch]
    per_prefill = want["per_prefill"]["spm_matmul"]
    expect = {"flash_attention": 0, "wkv6": 0}
    expect.update({k: 2 * n for k, n in want["per_prefill"].items()})
    expect["spm_matmul"] += 2 * want["mm_per_step"]
    planned = serve_paths(arch, plan)
    expect_paths = {"splitk": 2 * (want["mm_per_step"] - 1),
                    "wgmma": 2 * (per_prefill - 1), "tiled": 2 + 2}
    if tuned:
        expect_paths = planned
    elif planned != expect_paths:
        fail(f"{arch}: launch_plan with no cache gives the paths "
             f"{planned}, not {expect_paths}")
    phase = 8 if tuned else 5
    print(f"phase {phase} serve {arch}: kernel paths {paths} (2 prefills "
          f"and 2 decode steps through the wrappers; launch_plan gives "
          f"{planned})", flush=True)
    if launches != expect:
        fail(f"{arch}: wrapper launches {launches}, expected {expect}: "
             f"something timed ran eagerly")
    if paths["spm_matmul"] != expect_paths:
        fail(f"{arch}: spm_matmul paths {paths['spm_matmul']}, expected "
             f"{expect_paths}")
    for name in ("flash_attention", "wkv6"):
        got = paths[name]
        if name in want["kernels"] and (
                got["fma"] or got["tensor_core"] != launches[name]):
            fail(f"{arch}: {name} paths {got}: every launch must take "
                 f"the tensor-core kernel")


def serve_products(cfg, B, P):
    """(m, k, n, trans_b, count, pinned) of a serve's spm_matmul calls
    for one prefill and one decode step: the decode step's products
    (``tuning.model.decode_products``) carry the serving plan's pins;
    the prefill's run them at M = B x P without pins, with an encoder's
    products and a decoder's cross k/v, but its logits, taken at the
    last position (M = B)."""
    from repro_torch.tuning.model import decode_products
    decode = decode_products(cfg, B)
    prefill = [(B * P, k, n, tb, c) for _, k, n, tb, c in decode if not tb]
    if cfg.family == "encdec":
        # the encoder's layers (frames as long as the prompt) and the
        # decoder's cross k/v, which decode does not run
        a, d, E = cfg.attention, cfg.d_model, cfg.encdec.encoder_layers
        hq, hkv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
        prefill += [(B * P, d, hq, False, E), (B * P, hq, d, False, E),
                    (B * P, d, hkv, False, 2 * (E + cfg.num_layers)),
                    (B * P, d, cfg.d_ff, False, E),
                    (B * P, cfg.d_ff, d, False, E)]
    prefill += [(B, k, n, tb, c) for _, k, n, tb, c in decode if tb]
    return ([p + (True,) for p in decode]
            + [p + (False,) for p in prefill])


def serve_paths(arch, plan):
    """The spm_matmul launches by path that two prefills and two decode
    steps of ``arch``'s serve make under ``plan``, as
    ``ops.launch_plan`` resolves each product (pins, then the active
    plan cache)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.spm_matmul import ops
    cfg = get_config(arch)
    counts = dict.fromkeys(ops.matmul.paths, 0)
    for m, k, n, tb, c, pinned in serve_products(
            cfg, 4, SERVES[arch]["prompt"]):
        pins = (plan["mm_bm"], plan["mm_bn"]) if pinned else (None, None)
        path = ops.launch_plan(m, k, n, torch.bfloat16, tb, True,
                               *pins)["path"]
        counts[path] += 2 * c
    return counts


# ------------------------------------------------------------- train

# phase 9(c): TRAIN_4K's sequence length; the global batch is cut from
# 256 to 4 for one card
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 4096, 12
TRAIN_ARGV = ["--arch", "qwen2-0.5b", "--full", "--steps", str(TRAIN_STEPS),
              "--batch", str(TRAIN_B), "--seq", str(TRAIN_S)]
# phase 9(b): one step's gradient of every leaf, card against CPU, as a
# share of the leaf's largest |gradient| on the CPU, and 5 losses (the
# reduced fp32 qwen2: differently ordered fp32 sums in every product and
# reduction of the forward and the backward, as phase 4's MODEL_TOL)
GRAD_TOL = 1e-4
GRAD_STEPS = 5
# phase 9(c), after the run: DESCENT_STEPS steps on the first step's
# batch alone at the launcher's peak rate must lower that batch's loss
# by more than DESCENT_MARGIN x the spread of SPREAD_BATCHES batches'
# losses (``train_descent``); each variant of the training path takes
# one warm-up step and VARIANT_STEPS timed
DESCENT_STEPS, SPREAD_BATCHES, DESCENT_MARGIN = 5, 4, 10
VARIANT_STEPS = 3
# phase 9(d): the reduced bf16 run disturbed by a NaN step at NAN_STEP and
# a preemption at PREEMPT_STEP, then resumed, against an undisturbed one
RESUME_STEPS, NAN_STEP, PREEMPT_STEP = 8, 2, 4


def train_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen2-0.5b")


def train_products(cfg, B, S, loss_chunk, remat=False):
    """``(what, m, k, n, trans_b, out_fp32, count)``: the spm_matmul
    launches one training step of a dense decoder makes, reckoned from
    the code.  Forward: each layer product (``tuning.model
    .decode_products``' per-layer shapes at M = B x S) and each loss
    chunk's logits (``lm.lm_loss``: S / loss_chunk chunks of B x
    loss_chunk rows against the [V, d] table, fp32 out); backward
    (``SpmMatmul.backward``): dA through ``trans_b`` (a ``trans_b``
    forward: without), dB on the transposed copy of the smaller of A and
    dC (``ops.grad_b``), and each loss chunk's logits once more (its
    ``torch.utils.checkpoint`` recompute; with ``remat`` each layer's
    forward too)."""
    from repro_torch.tuning.model import decode_products
    T = B * S
    out = []
    for _, k, n, tb, c in decode_products(cfg, B):
        if tb:
            continue
        out += [("fwd", T, k, n, False, False, c * (2 if remat else 1)),
                ("dA", T, n, k, True, False, c)]
        out.append(("dB", k, T, n, False, False, c) if k <= n
                   else ("dB", n, T, k, False, False, c))
    C = loss_chunk if (loss_chunk and S % loss_chunk == 0
                       and S > loss_chunk) else S
    R, d, V = B * C, cfg.d_model, cfg.padded_vocab
    chunks = S // C
    out += [("logits fwd", R, d, V, True, True, 2 * chunks),
            ("logits dA", R, V, d, False, False, chunks),
            ("logits dB", d, R, V, False, False, chunks)]
    return out


def train_paths(products):
    """The spm_matmul launches by path of ``products``, as
    ``ops.launch_plan`` resolves each (bf16, aligned)."""
    from repro_torch.kernels.spm_matmul import ops
    counts = dict.fromkeys(ops.matmul.paths, 0)
    for _, m, k, n, tb, _, c in products:
        counts[ops.launch_plan(m, k, n, torch.bfloat16, tb, True)["path"]] \
            += c
    return counts


def run_train_case(label, fn, plain, lib, args, fault_args, flops,
                   nbytes, main=True, extra=None):
    """One phase-9(a) gradient product: the wrapper call ``fn(*args)``
    held element by element to its plain version on the same inputs,
    run twice for the same bits; a planted fault (``fault_args``: one
    16-deep step of the contraction zeroed) must break the check; then
    the call's time, the plain version's, ``torch.mm``'s and the bound."""
    from repro_torch.kernels.spm_matmul import ops
    from repro_torch.kernels.tolerance import ATOL_FRAC, RTOL, check
    dt = torch.bfloat16
    before = dict(ops.matmul.paths)
    got = fn(*args)
    torch.cuda.synchronize()
    path = launched_path(ops.matmul.paths, before)
    if path != "wgmma":
        fail(f"train {label}: launched {path}, expected wgmma")
    if not torch.equal(got, fn(*args)):
        fail(f"train {label}: two runs differ")
    want = plain(*args)
    ratio, diff = check(got, want, dt)
    if not ratio < 1:
        fail(f"train {label}: error at {ratio:.3f} of its allowance")
    fault, _ = check(fn(*fault_args), want, dt)
    if not fault > 1:
        fail(f"train {label}: the check misses a dropped K step "
             f"({fault:.3f} of its allowance)")
    row = {"kernel": "spm_matmul", "case": f"train {label}",
           "shape": list(got.shape), "dtype": str(dt), "path": path,
           "deterministic": True, "err_ratio": ratio, "fault_ratio": fault,
           "max_abs_err": diff, "rtol": RTOL[dt], "atol_frac": ATOL_FRAC[dt],
           "main_path": main, **(extra or {})}
    row["ms"] = time_ms(fn, [args], min_reps=5)
    row["plain_ms"] = time_ms(plain, [args], min_reps=5)
    row["library_ms"] = time_ms(lib, [args], min_reps=5)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
    print(f"  spm_matmul train {label:22s} -> {list(got.shape)} {path} err "
          f"{ratio:.3f} of allowance (dropped K step {fault:.1f})  kernel "
          f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  torch.mm "
          f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    return row


def phase_train_kernels(dev):
    """Phase 9(a): the backward's products at qwen2's training widths
    (T = 4 x 4096 rows; d 896, k/v 128, FFN 4864; the loss chunk's 2048
    rows against the 151,936-row table) and the forward flash launch."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.spm_matmul import ops
    from repro_torch.kernels.tolerance import check
    from repro_torch.launch import train
    cfg = train_cfg()
    gen = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    T, d = TRAIN_B * TRAIN_S, cfg.d_model
    R = TRAIN_B * train.LOSS_CHUNK
    V = cfg.padded_vocab
    hkv = cfg.attention.num_kv_heads * cfg.attention.head_dim

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def drop_cols(t):
        t = t.clone()
        t[:, -16:] = 0
        return t

    def drop_rows(t):
        t = t.clone()
        t[-16:] = 0
        return t

    rows = []
    for what, k, n in (("q/o", d, d), ("k/v", d, hkv),
                       ("gate/up", d, cfg.d_ff), ("down", cfg.d_ff, d)):
        x, w, dc = rnd(T, k), rnd(k, n, scale=k ** -0.5), rnd(T, n)
        rows.append(run_train_case(
            f"{what} dA {T}x{n}x{k}ᵀ",
            lambda g, b: ops.grad_a(g, b, False, bf),
            lambda g, b: ops.matmul_plain(g, b, bf, trans_b=True),
            lambda g, b: torch.mm(g, b.t()), (dc, w), (drop_cols(dc), w),
            2 * T * n * k, 2 * (T * n + k * n + T * k)))
        rows.append(run_train_case(
            f"{what} dB {k}x{T}x{n}",
            lambda a, g: ops.grad_b(a, g, False, bf),
            lambda a, g: ops.matmul_plain(a.t(), g, bf),
            lambda a, g: torch.mm(a.t(), g), (x, dc), (drop_rows(x), dc),
            2 * T * n * k, 2 * (T * k + T * n + k * n),
            extra={"copied": "A" if k <= n else "dC"}))
        del x, w, dc
    x, table = rnd(R, d), rnd(V, d, scale=d ** -0.5)
    dc32 = 1e-3 * torch.randn(R, V, generator=gen, device=dev)
    dc = dc32.to(bf)
    f32 = torch.float32
    rows.append(run_train_case(
        f"logits fwd {R}x{d}x{V}ᵀ fp32 out",
        lambda a, b: ops.matmul(a, b, trans_b=True, out_dtype=f32),
        lambda a, b: ops.matmul_plain(a, b, f32, trans_b=True),
        lambda a, b: torch.mm(a, b.t(), out_dtype=f32),
        (x, table), (drop_cols(x), table), 2 * R * d * V,
        2 * (R * d + V * d) + 4 * R * V))
    # the logits' dA from the bf16-rounded dC, and what the plain fp32
    # product of the unrounded dC costs and differs by
    rows.append(run_train_case(
        f"logits dA {R}x{V}x{d}",
        lambda g, b: ops.grad_a(g, b, True, bf),
        lambda g, b: ops.matmul_plain(g, b, bf),
        lambda g, b: torch.mm(g, b), (dc, table), (drop_cols(dc), table),
        2 * R * d * V, 2 * (R * V + V * d + R * d)))
    fp32_ms = time_ms(lambda g, b: ops.matmul_plain(g, b, bf), [(dc32, table)],
                      min_reps=5)
    cast_ms = time_ms(lambda g: g.to(bf), [(dc32,)], min_reps=5)
    vs_fp32, _ = check(ops.grad_a(dc, table, True, bf),
                       ops.matmul_plain(dc32, table, bf), bf)
    rows[-1].update({"fp32_plain_ms": fp32_ms, "cast_ms": cast_ms,
                     "err_vs_fp32_dc": vs_fp32})
    print(f"  logits dA: the fp32 dC rounded to bf16 ({cast_ms:.4f} ms) "
          f"feeds the bf16 kernel; the plain fp32 product of the unrounded "
          f"dC takes {fp32_ms:.4f} ms; kernel vs it {vs_fp32:.3f} of the "
          f"bf16 allowance", flush=True)
    rows.append(run_train_case(
        f"logits dB {d}x{R}x{V}",
        lambda a, g: ops.grad_b(a, g, True, bf),
        lambda a, g: ops.matmul_plain(g.t(), a, bf),
        lambda a, g: torch.mm(g.t(), a), (x, dc), (drop_rows(x), dc),
        2 * R * d * V, 2 * (R * d + R * V + V * d),
        extra={"copied": "A"}))
    del x, table, dc32, dc
    # the forward attention at the training shape
    a = cfg.attention
    q = rnd(TRAIN_B, TRAIN_S, a.num_heads, a.head_dim)
    k, v = (rnd(TRAIN_B, TRAIN_S, a.num_kv_heads, a.head_dim)
            for _ in range(2))
    before = dict(fa.attention.paths)
    got = fa.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    path = launched_path(fa.attention.paths, before)
    if path != "tensor_core" or not torch.equal(got, fa.attention(q, k, v)):
        fail(f"train flash: path {path}, or two runs differ")
    want = fa.attention_plain(q, k, v, causal=True)
    ratio, diff = check(got, want, bf)
    fault, _ = check(fa.attention(q, k, v, scale=1.05 / math.sqrt(
        a.head_dim)), want, bf)
    if not ratio < 1 or not fault > 1:
        fail(f"train flash: error {ratio:.3f}, planted fault {fault:.3f} "
             f"of the allowance")
    del got, want
    mask = mask_of(TRAIN_S, TRAIN_S, True, 0, dev)
    row = {"kernel": "flash_attention", "case": "train forward",
           "shape": [TRAIN_B, TRAIN_S, TRAIN_S, a.num_heads,
                     a.num_kv_heads, a.head_dim], "causal": True,
           "window": 0, "dtype": str(bf), "path": path,
           "deterministic": True, "err_ratio": ratio, "fault_ratio": fault,
           "max_abs_err": diff, "main_path": True,
           "ms": time_ms(lambda x, y, z: fa.attention(x, y, z), [(q, k, v)],
                         min_reps=5),
           "plain_ms": time_ms(lambda x, y, z: fa.attention_plain(x, y, z),
                               [(q, k, v)], min_reps=3)}
    row["library_ms"], row["library_backend"] = library_attention_ms(
        q, k, v, True, 0, mask)
    row["bound_ms"], row["bound_by"] = bound(
        (2 * q.numel() + k.numel() + v.numel()) * 2,
        4 * a.head_dim * int(mask.sum()) * TRAIN_B * a.num_heads, bf)
    print(f"  flash_attention train B{TRAIN_B} S{TRAIN_S} H{a.num_heads}/"
          f"{a.num_kv_heads} D{a.head_dim} causal {path} err {ratio:.3f} "
          f"(scale x1.05 {fault:.1f})  kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  library {row['library_ms']} ms "
          f"(SDPA {row['library_backend']})  bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    rows.append(row)
    del q, k, v, mask
    release()
    print(f"phase 9 train kernels: {len(rows)} cases within tolerance, "
          f"each planted fault caught", flush=True)
    return rows


def _fan_in_qk(params, cfg):
    """q/k at the fan-in of their d inputs (the reduced init's softmax is
    otherwise one-hot up to near ties, which fp32 rounding decides)."""
    a = cfg.attention
    for key, stage in params.items():
        if key.startswith("stage"):
            for pos in stage.values():
                for name in ("wq", "wk"):
                    pos["attn"][name].mul_(
                        math.sqrt(a.num_heads / cfg.d_model))


def phase_train_grads(dev):
    """Phase 9(b): reduced fp32 qwen2 (2 layers, remat on), one step's
    gradient of every leaf and 5 steps of loss, card against CPU."""
    import dataclasses

    from repro_torch.configs import TrainConfig, reduce_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_items, tree_map
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(reduce_config(
        train_cfg(), layers=2, d_model=128, vocab=512), dtype="float32")
    opts = lm.RunOptions(chunk_q=32, chunk_kv=32, loss_chunk=32, remat=True)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2,
                       total_steps=GRAD_STEPS)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         global_batch=4, seq_len=128))
    cpu_params = lm.init_params(cfg, seed=0, device="cpu")
    _fan_in_qk(cpu_params, cfg)
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        params = tree_map(lambda t: t.to(d), cpu_params)
        batches = [{k: torch.from_numpy(v).to(d, torch.long)
                    for k, v in data.batch_at(i).items()}
                   for i in range(GRAD_STEPS)]
        _, grads = adamw.value_and_grad(
            lambda p, b: lm.train_loss(cfg, p, b, opts), params, batches[0])
        step = adamw.make_train_step(cfg, tcfg, opts)
        opt, losses = adamw.adamw_init(params), []
        for b in batches:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
        runs[name] = ({k: g.cpu() for k, g in tree_items(grads)}, losses)
    worst = max((rel_err(g, runs["cpu"][0][k])[0], k)
                for k, g in runs["cuda"][0].items())
    loss_err = max(abs(a - b) / b for a, b in zip(runs["cuda"][1],
                                                  runs["cpu"][1]))
    print(f"phase 9 train grads: reduced qwen2-0.5b fp32 (2 layers, remat, "
          f"batch 4 x 128) card vs CPU: worst leaf gradient {worst[0]:.2e} "
          f"of its largest magnitude ({worst[1]}; {len(runs['cpu'][0])} "
          f"leaves; tol {GRAD_TOL:.0e}); {GRAD_STEPS} losses "
          f"{[round(x, 6) for x in runs['cuda'][1]]}, worst rel err "
          f"{loss_err:.2e} (tol {GRAD_TOL:.0e})", flush=True)
    if not worst[0] < GRAD_TOL or not loss_err < GRAD_TOL:
        fail("card and CPU gradients or losses disagree")
    return {"worst_grad_rel": worst[0], "worst_leaf": worst[1],
            "loss_rel": loss_err, "losses": runs["cuda"][1]}


# a training step's kernels by family: the attention backward's
# recompute (flash_attention's attention_grad) runs its products on
# cuBLAS
TRAIN_FAMILIES = (
    TRACE_FAMILIES[:3]
    + (("cuBLAS products (attention backward's recompute)",
        TRACE_FAMILIES[3][1]),)
    + TRACE_FAMILIES[4:])


def phase_train(dev):
    """Phase 9(c): full-width qwen2-0.5b through the training entry point;
    launch counters zeroed just before it and read just after."""
    from repro_torch.launch import train
    from repro_torch.models import lm
    release()
    reset_launches()
    res = train.main(TRAIN_ARGV)
    paths = path_counts()
    cfg = train_cfg()
    products = train_products(cfg, TRAIN_B, TRAIN_S, train.LOSS_CHUNK)
    want = train_paths(products)
    want_flash = cfg.num_layers
    per_step = res["launches_per_step"]
    loss, js = res["loss"], res["jitter"]
    print(f"phase 9 train: repro_torch.launch.train {' '.join(TRAIN_ARGV)} "
          f"(global batch cut from 256 to {TRAIN_B} for one card; seq "
          f"{TRAIN_S}, TRAIN_4K's): loss {loss[0]:.4f} -> {loss[-1]:.4f} "
          f"(gradient norm {res['grad_norm'][0]:.4g} -> "
          f"{res['grad_norm'][-1]:.4g}); "
          f"step median {js['median'] * 1e3:.2f} ms, p99 "
          f"{res['p99_s'] * 1e3:.2f} ms, CoV {js['cov']:.4f} over steps 3-"
          f"{TRAIN_STEPS}; {res['tokens_per_s']:,.0f} tokens/s; model FLOPs "
          f"a step, as a share of 989 TFLOP/s: launch/train.py's "
          f"(6 x params x tokens + causal attention) "
          f"{res['model_flops']:.4g}, {res['peak_flop_share']:.4f}; the "
          f"reference's analysis.flops.model_flops (6 x active params x "
          f"tokens) {res['reference_model_flops']:.4g}, "
          f"{res['reference_peak_flop_share']:.4f}; peak memory {res['peak_memory'] / 2**30:.2f} "
          f"GiB (torch.cuda.max_memory_allocated); deadline "
          f"{res['deadline']['deadline_s'] * 1e3:.1f} ms, overruns "
          f"{res['deadline']['overruns']}", flush=True)
    print(f"phase 9 train: launches per step {per_step[-1]} (reckoned: "
          f"spm_matmul {want}, {sum(want.values())} in all; flash_attention "
          f"{want_flash}); over the run {paths['spm_matmul']} and "
          f"{paths['flash_attention']}", flush=True)
    if not all(map(math.isfinite, loss)):
        fail(f"non-finite losses: {loss}")
    for i, st in enumerate(per_step):
        if st["spm_matmul"] != want or st["flash_attention"] != want_flash:
            fail(f"train step {i + 1} launched {st}, reckoned spm_matmul "
                 f"{want} and flash_attention {want_flash}")
    if paths["wkv6"]["tensor_core"] or paths["wkv6"]["fma"]:
        fail("wkv6 launched in qwen2's training")
    launches = {"spm_matmul": sum(paths["spm_matmul"].values()),
                "flash_attention": sum(paths["flash_attention"].values()),
                "wkv6": 0}
    # the last loss must be below the first, and so must the first
    # step's batch's under the trained parameters; 12 steps (10 of them
    # warm-up) move a new batch's loss by little, so train_descent reads
    # the fall again against the spread between batches.  The run is
    # deterministic: the same code gives the same losses on any card
    tr, state = res["trainer"], res["final_state"]
    batch0 = tr.batch_at(0)
    with torch.no_grad():
        again = float(lm.train_loss(cfg, state.params, batch0, tr.opts))
    print(f"phase 9 train: the first step's batch after training: loss "
          f"{again:.4f} (first {loss[0]:.4f}, last {loss[-1]:.4f})",
          flush=True)
    if not (loss[-1] < loss[0] and again < loss[0]):
        fail(f"the loss did not fall: first {loss[0]}, last {loss[-1]}, "
             f"the first batch after training {again}")
    # one more step, traced: device time by kernel family
    trace = trace_replays(
        "train step (full-width qwen2-0.5b, batch 4 x 4096)",
        lambda i: tr._step_fn(state.params, state.opt_state, batch0), 2,
        phase=9, families=TRAIN_FAMILIES)
    variants = train_variants(cfg, tr, state, batch0)
    descent = train_descent(cfg, tr, state)
    out = {k: v for k, v in res.items()
           if k not in ("final_state", "trainer")}
    out.update({"first_batch_loss_after": again, "trace": trace,
                "variants": variants, "descent": descent})
    del tr, state, res
    release()
    return out, launches


def train_variants(cfg, tr, state, batch):
    """Phase 9(c): the full-width step under variants of the training
    path, in one process, each from the trained parameters and optimizer
    state on the first step's batch (the update not kept): one warm-up
    step and VARIANT_STEPS timed (host clock around a step that ends in
    a synchronize), the peak memory (``torch.cuda.max_memory_allocated``
    from the variant's first step; the trainer's state is resident
    throughout) and the loss, which must be the same bits in every
    variant.

      baseline     the port as it is: each stacked stage leaf unbound
                   once a step (``lm._unit_params``), each loss chunk's
                   logits recomputed in the backward, no remat
      index        each unit's leaves indexed one unit at a time
                   (``blk.tree_index``): each index's backward fills a
                   gradient the size of the whole stacked leaf
      keep-logits  the loss chunks not recomputed (``lm.checkpoint`` a
                   direct call): autograd keeps every chunk's fp32
                   logits, as the reference's scan does
      remat        ``RunOptions.remat``: each unit recomputed

    ``index`` and ``keep-logits`` replace a name of ``models.lm`` for
    their steps and put it back."""
    import dataclasses
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    def indexed(sp, n):
        return [blk.tree_index(sp, i) for i in range(n)]

    def direct(fn, *a, use_reentrant=False):
        return fn(*a)

    variants = [("baseline", tr.opts, {}),
                ("index", tr.opts, {"_unit_params": indexed}),
                ("keep-logits", tr.opts, {"checkpoint": direct}),
                ("remat", dataclasses.replace(tr.opts, remat=True), {})]
    out = {}
    for name, opts, patches in variants:
        saved = {k: getattr(lm, k) for k in patches}
        for k, v in patches.items():
            setattr(lm, k, v)
        try:
            step = adamw.make_train_step(cfg, tr.tcfg, opts)
            release()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(VARIANT_STEPS + 1):
                t0 = time.monotonic()
                _, _, m = step(state.params, state.opt_state, batch)
                torch.cuda.synchronize()
                times.append(time.monotonic() - t0)
        finally:
            for k, v in saved.items():
                setattr(lm, k, v)
        out[name] = {"step_ms": [t * 1e3 for t in times[1:]],
                     "median_ms": float(np.median(times[1:])) * 1e3,
                     "peak_memory": torch.cuda.max_memory_allocated(),
                     "loss": m["loss"].item()}
        del m, step
    base = out["baseline"]
    for name, v in out.items():
        d_ms = v["median_ms"] - base["median_ms"]
        print(f"phase 9 train variants: {name:11s} step median "
              f"{v['median_ms']:8.2f} ms ({d_ms:+.2f};"
              f" steps {', '.join(f'{t:.2f}' for t in v['step_ms'])}), peak "
              f"memory {v['peak_memory'] / 2**30:6.2f} GiB "
              f"({(v['peak_memory'] - base['peak_memory']) / 2**30:+.2f}),"
              f" loss {v['loss']!r}", flush=True)
    if len({v["loss"] for v in out.values()}) != 1:
        fail("the training path's variants disagree on the loss")
    release()
    return out


def descend(cfg, tr, params, opt):
    """DESCENT_STEPS steps of the launcher's update at its peak rate (no
    warm-up, no decay) on the first step's batch alone, from ``params``
    and ``opt``: the first SPREAD_BATCHES batches' losses before, each
    step's loss and gradient norm, the first batch's loss after, and
    the parameters and state the steps end with."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    batches = [tr.batch_at(i) for i in range(SPREAD_BATCHES)]
    with torch.no_grad():
        at = [float(lm.train_loss(cfg, params, b, tr.opts))
              for b in batches]
    tcfg = dataclasses.replace(tr.tcfg, warmup_steps=0, total_steps=1 << 30)
    step = adamw.make_train_step(cfg, tcfg, tr.opts)
    losses, norms = [], []
    for _ in range(DESCENT_STEPS):
        params, opt, m = step(params, opt, batches[0])
        if not m["finite"]:
            fail("a non-finite step on the first batch")
        losses.append(m["loss"].item())
        norms.append(float(m["grad_norm"]))
    with torch.no_grad():
        after = float(lm.train_loss(cfg, params, batches[0], tr.opts))
    res = {"losses_before": at, "spread": max(at) - min(at),
           "step_losses": losses, "grad_norms": norms, "after": after,
           "fall": at[0] - after, "lr": tcfg.learning_rate}
    return res, params, opt


def _descent_line(what, r):
    return (f"{what}: {DESCENT_STEPS} steps on the first batch alone at "
            f"lr {r['lr']:g}: its loss {r['losses_before'][0]:.4f} -> "
            f"{r['after']:.4f} (fall {r['fall']:.4f}; step losses "
            f"{', '.join(f'{x:.4f}' for x in r['step_losses'])}; gradient "
            f"norms {', '.join(f'{x:.4g}' for x in r['grad_norms'])}); "
            f"spread of {SPREAD_BATCHES} batches' losses before "
            f"{r['spread']:.4f} ("
            f"{', '.join(f'{x:.4f}' for x in r['losses_before'])})")


def train_descent(cfg, tr, state):
    """Phase 9(c): is the update real?  Read first on the trained
    24-layer model, where it is only printed: its gradient norm is
    astronomically large (the reference's ``scaled`` init takes wq, wk
    and wv's fan-in from their head axis, so attention is near one-hot
    at init and the gradient grows geometrically with depth;
    ``tests/test_torch_train.py`` holds the port's growth to the
    reference's), and its loss moves by about the spread between
    batches.  Then held at the same widths at 2 layers,
    from init (seed 0): the first batch's loss must fall by more than
    DESCENT_MARGIN x the spread of the first SPREAD_BATCHES batches'
    losses, every leaf's first moment must be non-zero after the steps
    (its gradient reached it) and every leaf not constant at init must
    have moved from it (norm weights at 1.0 may stay: a bf16 1.0 moves
    only by more than half its ulp)."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_items
    from repro_torch.optim import adamw
    deep, _, _ = descend(cfg, tr, state.params, state.opt_state)
    print(_descent_line(f"phase 9 train descent: the trained "
                        f"{cfg.num_layers}-layer model (printed, not "
                        f"held)", deep), flush=True)
    release()
    two = dataclasses.replace(cfg, num_layers=2)
    init = lm.init_params(two, tr.tcfg.seed, tr.device)
    res, p, o = descend(two, tr, init, adamw.adamw_init(init))
    still = [path for path, leaf in tree_items(o["m"])
             if not bool(leaf.any())]
    unmoved = [path for (path, a), (_, b) in zip(tree_items(init),
                                                 tree_items(p))
               if bool((a != a.reshape(-1)[0]).any()) and torch.equal(a, b)]
    print(_descent_line("phase 9 train descent: the same widths at 2 "
                        "layers from init (held)", res)
          + f"; the fall must exceed {DESCENT_MARGIN} x the spread; "
          f"leaves with a zero first moment {len(still)} of "
          f"{len(list(tree_items(p)))}, leaves unchanged from a random "
          f"init {len(unmoved)}", flush=True)
    if not res["fall"] > DESCENT_MARGIN * res["spread"] or still \
            or unmoved:
        fail(f"the update is not real: fall {res['fall']} against "
             f"spread {res['spread']}; zero first moment {still}; "
             f"unchanged {unmoved}")
    del init, p, o
    release()
    return {"deep": deep, "two_layers": res}


def _state_bits(state):
    from repro_torch.models.spec import tree_items
    return [t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
            for _, t in tree_items({"p": state.params, "o": state.opt_state})]


def phase_train_resume(dev):
    """Phase 9(d): a reduced bf16 run with one NaN step, then a save, a
    preemption and a resume, bit-identical to an undisturbed run in the
    parameters and the optimizer state."""
    from repro_torch.configs import TrainConfig, reduce_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.lm import RunOptions
    from repro_torch.resilience import Fault, FaultPlan
    from repro_torch.runtime.trainer import Trainer
    cfg = reduce_config(train_cfg(), layers=2, d_model=128, vocab=512)
    root = OUT_DIR / "train_resume"
    if root.exists():
        import shutil
        shutil.rmtree(root)

    def trainer(name, chaos=None):
        return Trainer(cfg, TrainConfig(learning_rate=1e-2, warmup_steps=2,
                                        total_steps=RESUME_STEPS),
                       DataConfig(vocab_size=cfg.vocab_size, global_batch=4,
                                  seq_len=128),
                       ckpt_dir=str(root / name), ckpt_every=3,
                       opts=RunOptions(loss_chunk=64, remat=False),
                       log_every=0, chaos=chaos, device=dev)

    ref = trainer("ref")
    ref.run(RESUME_STEPS)
    first = trainer("chaos", FaultPlan([Fault(NAN_STEP, "nan_loss"),
                                        Fault(PREEMPT_STEP, "preempt")]))
    first.run(RESUME_STEPS)
    resumed = trainer("chaos")
    resumed.run(RESUME_STEPS)
    same = _state_bits(resumed.final_state) == _state_bits(ref.final_state)
    print(f"phase 9 train resume: reduced qwen2-0.5b bf16 (2 layers, batch "
          f"4 x 128) on the card: NaN step {first.nonfinite_steps}, "
          f"preempted and saved at step {first.final_state.step}, resumed "
          f"to {resumed.final_state.step}; parameters and optimizer state "
          f"bit-identical to an undisturbed run: {same}", flush=True)
    if (first.nonfinite_steps != [NAN_STEP]
            or first.final_state.step != PREEMPT_STEP + 1
            or resumed.final_state.step != RESUME_STEPS or not same):
        fail("the disturbed run did not resume bit-identical")
    return {"nonfinite_steps": first.nonfinite_steps,
            "preempted_at": first.final_state.step, "bit_identical": same}


# phase 10: (module, arch, shape, extra arguments); each its own process
DRYRUNS = [
    ("repro_torch.launch.dryrun", "qwen2-0.5b", "train_4k",
     ["--multi-pod", "both"]),
    ("repro_torch.launch.roofline_run", "qwen2-0.5b", "decode_32k", []),
    ("repro_torch.launch.dryrun", "zamba2-7b", "prefill_32k", []),
    ("repro_torch.launch.roofline_run", "zamba2-7b", "prefill_32k", []),
]
DRYRUN_TIMEOUT_S = 600


def piece_collectives(rec):
    """A roofline record's collective bytes by kind: each piece's times
    its multiplier."""
    out = {}
    for pc in rec["pieces"]:
        for kind, v in pc["collectives"].items():
            out[kind] = out.get(kind, 0.0) + pc["multiplier"] * v["bytes"]
    return out


def phase_dryrun():
    """Phase 10: the dry run and the roofline, each command in a
    subprocess (the process group is global to a process, and this one
    holds the card); every record must say ok."""
    import shutil
    from repro_torch.analysis.roofline import roofline_terms
    out = OUT_DIR / "dryrun"
    if out.exists():
        shutil.rmtree(out)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    records = {}
    for module, arch, shape, extra in DRYRUNS:
        sub = out / module.rsplit(".", 1)[1]
        cmd = [sys.executable, "-m", module, "--arch", arch, "--shape",
               shape, "--out", str(sub)] + extra
        t0 = time.time()
        r = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=DRYRUN_TIMEOUT_S)
        print(f"phase 10 dryrun: python -m {' '.join(cmd[2:])}: exit "
              f"{r.returncode} in {time.time() - t0:.1f} s", flush=True)
        files = sorted(sub.glob(f"{arch}__{shape}*.json"))
        if r.returncode != 0 or not files:
            print(r.stdout[-3000:], r.stderr[-3000:], flush=True)
        if not files:
            fail(f"{module} {arch} {shape} wrote no record")
        for f in files:
            rec = json.loads(f.read_text())
            key = f"{sub.name}:{f.stem}"
            records[key] = rec
            if rec["status"] != "ok":
                fail(f"{key}: status {rec['status']}: {rec.get('error')}")
            if "pieces" in rec:
                flops = rec["composed"]["flops"]
                colls = piece_collectives(rec)
                terms = rec["terms"]
                what = (f"{len(rec['pieces'])} pieces composed; memory "
                        f"term from the analytic bytes "
                        f"{rec['analytic_bytes']['total']:.4g}; useful "
                        f"FLOP ratio {rec['useful_ratio']:.4f}")
            else:
                flops = rec["flops"]
                colls = {k: v["bytes"] for k, v in
                         rec["collectives"].items()}
                terms = roofline_terms(flops, rec["bytes_accessed"],
                                       rec["collective_bytes"])
                rec["terms_h100"] = terms
                what = (f"{rec['n_devices']} devices; memory term from the "
                        f"unfused traced bytes {rec['bytes_accessed']:.4g}; "
                        f"{rec['view_gathers']} view gathers")
            print(f"phase 10 dryrun {key}: status {rec['status']} "
                  f"({rec['total_s']} s); per-device FLOPs {flops:.4g}; "
                  f"collective bytes {colls}; {what}; H100 roofline: "
                  f"compute {terms['compute_s']:.4g} s, memory "
                  f"{terms['memory_s']:.4g} s, collective "
                  f"{terms['collective_s']:.4g} s, {terms['dominant']}-"
                  f"bound", flush=True)
        if r.returncode != 0:
            fail(f"{' '.join(cmd[2:])} exited {r.returncode}")
    return records


def path_counts():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.spm_matmul import ops as mm_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    return {"spm_matmul": dict(mm_ops.matmul.paths),
            "flash_attention": dict(fa_ops.attention.paths),
            "wkv6": dict(wkv_ops.wkv.paths)}


def reset_launches():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.spm_matmul import ops as mm_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    mm_ops.matmul.launches = 0
    fa_ops.attention.launches = 0
    wkv_ops.wkv.launches = 0
    for counts in (mm_ops.matmul.paths, fa_ops.attention.paths,
                   wkv_ops.wkv.paths):
        counts.update(dict.fromkeys(counts, 0))


def kernel_summary(rows, launches, replayed, trained):
    """One entry per kernel; times and bounds summed over its main-path
    cases (each shape once, every served model and the training path),
    errors the largest of those cases.  ``launches`` is the wrappers'
    count over the serve runs and phase 9's training run (summed),
    ``train_launches`` the training run's share, ``replayed_launches``
    what the timed prefill and decode graphs' replays launched."""
    from repro_torch.kernels import _build
    replaced = {
        "spm_matmul": "src/repro/kernels/spm_matmul/spm_matmul.py:50",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:75",
        "wkv6": "src/repro/kernels/wkv6/wkv6.py:84"}
    out = []
    for name, replaces in replaced.items():
        main = [r for r in rows if r["kernel"] == name and r["main_path"]]
        by = {"bytes": 0.0, "operations": 0.0}
        for r in main:
            by[r["bound_by"]] += r["bound_ms"]
        lib = [r["library_ms"] for r in main]
        out.append({
            "name": name, "route": "cuda",
            "source": str((_build.CSRC / f"{name}.cu").relative_to(ROOT)),
            "replaces": replaces,
            "launches": launches[name] + trained[name],
            "train_launches": trained[name],
            "replayed_launches": replayed[name],
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(by.values()),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in lib else sum(lib),
        })
    return out


def phase_train_phases(dev):
    """Phase 9, its four parts in order; returns the kernel rows of (a)
    and the results."""
    rows = phase_train_kernels(dev)
    grads = phase_train_grads(dev)
    run, launches = phase_train(dev)
    resume = phase_train_resume(dev)
    return rows, {"grads": grads, "run": run, "launches": launches,
                  "resume": resume, "cases": rows}


def main():
    if sys.argv[1:] == ["10"]:
        # the dry run alone, after the device: no result lines
        phase_device()
        OUT_DIR.mkdir(exist_ok=True)
        dry = phase_dryrun()
        (OUT_DIR / "chip_smoke_dryrun.json").write_text(json.dumps(
            dry, indent=1))
        return
    if sys.argv[1:] == ["9"]:
        # the training phase alone, after the device and the build: a
        # quicker check of that path, with no result lines
        os.environ["REPRO_AUTOTUNE"] = "0"
        dev, _ = phase_device()
        phase_build()
        OUT_DIR.mkdir(exist_ok=True)
        _, train = phase_train_phases(dev)
        (OUT_DIR / "chip_smoke_train.json").write_text(json.dumps(
            train, indent=1, default=str))
        return
    # phases 1-7 read no plan cache: they launch what they launched
    # before tuning existed (phase 8 turns it on)
    os.environ["REPRO_AUTOTUNE"] = "0"
    dev, smi = phase_device()
    build_s, registers = phase_build()
    rows = phase_kernels(dev)
    models = {arch: phase_model(dev, arch) for arch in MODELS}
    phase_moe_serve()
    OUT_DIR.mkdir(exist_ok=True)
    serves, captures = {}, {}
    for arch in SERVES:
        serves[arch] = phase_serve(arch)
        release()
        captures[arch] = phase_capture(dev, arch)
        release()
    report = phase_predictability(serves, captures)
    launches = {k: sum(l[k] for l, _ in serves.values())
                for k in serves["qwen2-0.5b"][0]}
    replayed = {k: sum(r["replayed_launches"][k] + r["prefill_launches"][k]
                       for _, r in serves.values())
                for k in launches}
    tuned = phase_tune(dev, smi)
    # phase 9 launches what the code launches untuned
    os.environ["REPRO_AUTOTUNE"] = "0"
    from repro_torch import tuning
    tuning.reset()
    train_rows, train = phase_train_phases(dev)
    rows += train_rows
    dry = phase_dryrun()
    kernels = kernel_summary(rows, launches, replayed, train["launches"])
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "build_s": build_s, "registers": registers, "cases": rows,
        "models": models,
        "kernels": kernels, "report": report, "tune": tuned,
        "train": {k: v for k, v in train.items() if k != "cases"},
        "dryrun": dry,
        "serve": {arch: {"prefill_ms": res["prefill_s"] * 1e3,
                         "decode_ms": [t * 1e3 for t in res["decode_s"]],
                         "jitter": res["jitter"],
                         "wcet_ms": res["wcet_s"] * 1e3,
                         "deadline": res["deadline"], "plan": res["plan"],
                         "launches": l, "paths": res["paths"],
                         "prefill_launches": res["prefill_launches"],
                         "replayed_launches": res["replayed_launches"],
                         **captures[arch]}
                  for arch, (l, res) in serves.items()}},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
