#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an H100.

  python3 chip_smoke.py          # from the root of a checkout, one card

Phases, one result line each; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi) and capability;
            anything but sm_90 fails.
2. build    nvcc builds every kernel of ``src/repro_torch/csrc`` for
            sm_90a, one process per source, all at once, and prints
            each kernel's registers and spills (``-Xptxas -v``) and
            any line of ptxas's that reports its wgmma serialised; such
            a line for a kernel of the tensor-core forward fails.
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
            path's.  wkv6's backward (``csrc/wkv6_bwd.cu``) at
            rwkv6-1.6b's training shape [4, 4096, 32, 64] (bf16, the
            model's decays), the serve shape, an fp32 case with the
            final state's gradient, a ragged S, more than one group of
            a cluster and K 32, 64 and 128, each on the path
            ``ops.bwd_dispatch`` routes it to (``tensor_core`` for
            aligned bf16, ``fma`` else; the training shape on ``fma``
            too), each of dr, dk, dv, dw_log and du against
            ``wkv_grad_plain`` (``tolerance.check_wkv_grad``), twice for
            the same bits, catching its planted faults (the adjoint not
            carried across a chunk boundary, dw_log's decay off by one
            position, du dropped, and at a cluster's group boundary the
            state not carried into the next group and the adjoint not
            carried into the previous one); the byte and the operations
            bound, and at the training shape each path's step shares
            (``WKV6_BWD_STEP_CLOCKS``).  Then the kernel's time, the plain version's, a
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
            prompt 512, two SSD chunks of 256; zamba2-7b-instruct, the
            published form: the same depth, the tied blocks at head dim
            224 with each hybrid layer's adapter and linear, prompt
            1024, the benchmark cell's; whisper-base: 6 encoder
            and 6 decoder layers, prompt 1536 and frames as long, the
            config's cross K/V length; pixtral-12b: 40 layers, prompt
            1024, the stub's patch positions, no patches fed; bf16,
            batch 4, 32 new tokens); qwen2-0.5b's then again, untimed
            for the report, with ``REPRO_TRACE`` set (on the card its
            graphs carry their module spans), whose tokens must be the
            plain serve's.  Launch counters are zeroed just before
            each serve and read just after; each kernel of that path
            must have launched, and all 4x32 tokens must come out (a
            deadline shed fails) in range.  The timed prefill and decode
            steps replay CUDA graphs captured before the timing, which
            pass no wrapper: the launches those replays made are read
            from ``serve.main``, and one prefill replay must launch each
            kernel once per layer (spm_matmul once per product), one
            decode replay the step's spm_matmul products (zamba2: 241
            spm_matmul and 13 flash_attention, at head dim 112, a prefill
            replay; 241 spm_matmul a decode replay; zamba2-7b-instruct:
            280 spm_matmul and 13 flash_attention, at head dim 224, a
            prefill replay, 280 spm_matmul a decode replay; whisper-base: 97
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
            both zamba2s' prefill graphs, replayed under
            ``torch.profiler``: the replay's time (CUDA events), the
            device's busy share, and its kernels' device time by family.
7. predictability  the jitter statistics (median, p99, spread, CoV,
            WCET margin) of each serve's 32 decode steps and of its
            prefill graph's replays timed by CUDA events (10 for qwen2,
            rwkv6 and whisper, 3 for gemma3, both zamba2s and pixtral),
            as a schema-v1 report
            (``repro_torch.obs.make_report``) that
            ``repro_torch.obs.validate_report`` must accept, written to
            ``chiprun_out/chip_smoke_report.json``; and qwen2's
            ``REPRO_TRACE`` file must hold 1 ``prefill`` span, 32
            ``decode*`` spans and 32 ``step_ms`` counters, and the
            module spans of 32 decode replays.

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
            plus the forward flash launch at [4, 4096, 14/2, 64] (its
            o the same bits with and without lse and o_lo, timed both
            ways, ``run_train_flash``); each
            held element by element to its plain version with a
            planted fault caught (phase 3's rule), run twice for the
            same bits, with its path, time, ``torch.mm``'s (SDPA's)
            and its bound.  Then flash_attention's backward
            (``csrc/flash_attention_bwd.cu``, ``run_flash_bwd``) at
            qwen2-0.5b's, zamba2-7b's and qwen3-moe's training shapes,
            gemma3's local layer (D 256, window 1024, batch 1), a
            cross shape (Sq 448, Sk 1500, unmasked), fp32 (D 64, and
            D 256 windowed), bf16 off the 16-byte grid and a ragged
            window: the forward's o the same bits with and without its
            lse and o_lo, that lse against the plain forward's, o + o_lo
            against the forward's fp32 output, the forward timed both
            ways; dq, dk and dv on
            the routed path (``tensor_core`` for aligned bf16, ``fma``
            else) against ``attention_grad`` evaluated in fp32
            (``tolerance.check_flash_grad``), twice for the same bits,
            three planted faults caught (the scale 5 % off, lse shifted,
            the last key tile dropped); the kernel's time and each of
            its launches' (dQ, dK/dV, the group sum; a profile), the
            plain version's and SDPA's backward time and the bound (the
            five products, 10 D x pairs x B x H) beside the products a
            pair the path runs.  (b) reduced qwen2 fp32 (2 layers, remat
            on): one step's gradient of every leaf and 5 steps of loss
            on the card against the CPU, within 1e-4.  (c)
            ``python -m repro_torch.launch.train --arch qwen2-0.5b
            --full --steps 12 --batch 4 --seq 4096`` (TRAIN_4K's
            sequence; the global batch cut from 256 to 4 for one card),
            counters zeroed just before and read just after: the last
            loss must be below the first, and so must the first step's
            batch's loss under the trained parameters, every step must
            launch the spm_matmul paths, the flash count and the flash
            backward's (one a layer, ``tensor_core``) reckoned from the
            code (``train_products``), and it prints the step
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
            (b) and (e) must launch flash_attention's ``fma``
            backward where the model has attention.
            (e) phase 4's reduced fp32 rwkv6-1.6b (2 layers: wkv6's
            forward and backward kernels in fp32), zamba2-7b (15) and
            qwen3-moe-235b-a22b (2): as (b), the losses at lr 1e-4,
            printed beside how far gradients perturbed by 1e-6 of each
            leaf's largest magnitude move the CPU's own losses at 1e-4
            and at (b)'s 1e-2.  (f) ``train.train`` of full-width
            rwkv6-1.6b (24 layers, bf16, batch 4 x 4096, 12 steps,
            remat), counters zeroed just before and read just after:
            every step must launch spm_matmul by path, wkv6's forward
            kernel (twice a layer: the step and remat's recompute) and
            its backward kernel (once a layer, every launch on the
            ``tensor_core`` path: ``wkv.bwd_paths``) as reckoned from
            the code; the last loss and the first step's batch's under the
            trained parameters below the first; step ms (median, p99,
            CoV), tokens/s, the model-FLOP shares, peak memory and
            overruns printed; one more step traced by kernel family.
            (g) the same for zamba2-7b at 15 layers and
            qwen3-moe-235b-a22b at 1 layer (``dataclasses.replace(cfg,
            num_layers=N)``, full width; batch 4 x 1024, 6 steps, no
            remat), where only the first step's batch's loss must fall
            (6 steps on new batches of a 32,000- or 151,936-token
            permutation chain move it by about the batches' spread).

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

11. multidevice  the multi-device layer and the MoE and large dense
            configs at full width, with no plan cache:
            (a) ``repro_torch.launch.serve.serve`` of
            ``dataclasses.replace(get_config(arch), num_layers=N)`` at
            full width (weights drawn on the card, as ``--full`` draws
            them; bf16, batch 4, prompt 256, 32 new tokens, prefill and
            decode on captured graphs as in phase 5):
            qwen3-moe-235b-a22b at 4 layers, llama4-maverick-400b-a17b
            at 2 (one MoE and one dense layer), deepseek-67b and
            qwen2-72b at 4.  Each as phase 5 holds its serves: every
            token in range, the decode products on split-K and the
            prefill products on wgmma, flash_attention on its tensor-core
            kernel (group 16 for qwen3-moe, 8 for the others, head dim
            128), the wrappers launching for exactly two prefills and
            two decode steps; it prints decode ms/step (median, p99,
            CoV), prefill ms, the WCET margin and the peak memory.
            qwen3-moe's decode graph and llama4's prefill graph are
            traced by family, the expert products (the batched einsums
            ``gecd,edf``) a family of their own: the cuBLAS kernels one
            eager call of ``ffn._expert_ffn`` launches at the served
            shapes, read off the profiler, whose count in the replay
            must be that call's times the MoE layers for the family to
            be exact.  (b) in a process of its own, rank 0 of a
            one-rank NCCL group: ``moe_ffn_ep`` on one qwen3-moe MoE
            layer at full width (bf16, tokens 4 x 256) on a 1x1 CUDA
            mesh, held element by element (phase 3's rule) to
            ``moe_ffn(impl="gather")`` with ``group_size`` 1024, the
            grouping EP uses, and the same check must catch the busiest
            expert's output slots shifted by one; (c) in the same
            process, reduced qwen2-0.5b's parameters saved by
            ``CheckpointManager`` and restored with ``shardings=`` onto
            the mesh, every leaf a DTensor on cuda and bit-identical,
            and ``compressed_grad_mean`` at pod size 1 returning its
            input.  (d) ``python -m repro_torch.launch.dryrun --arch
            qwen3-moe-235b-a22b --shape train_4k --variant moe_ep
            --multi-pod both`` and the same for llama4-maverick-400b-a17b
            at decode_32k, on the host's CPU beside phase 10's commands,
            all at once after the card's timed work: every record ok,
            with its collectives' counts and bytes by kind.

Then one JSON line with every kernel's numbers, the nvidia-smi line,
and, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the repository beside this file, it fails before printing
any result.  Per-case numbers also go to ``chiprun_out/chip_smoke.json``,
phase 11's record to ``chiprun_out/chip_smoke_multidevice.json``.
``python3 chip_smoke.py <name>`` runs one subset of ``SUBSETS`` and
prints no result lines: ``mm``, phases 1 and 2 and phase 3's
spm_matmul cases only (``chiprun_out/chip_smoke_matmul.json``); ``3``,
phases 1 and 2 and phase 3's wkv6 backward cases only
(``chiprun_out/chip_smoke_wkv_bwd.json``); ``fwd``,
phases 1 and 2 and the flash forward's cases, phase 3's and phase
9(a)'s train forward with and without lse and o_lo
(``chiprun_out/chip_smoke_flash_fwd.json``); ``9a``, phases 1 and 2
and phase 9(a)'s flash backward cases
(``chiprun_out/chip_smoke_flash_bwd.json``); ``9``, phases 1, 2 and 9
(``chiprun_out/chip_smoke_train.json``); ``10``, phases 1 and 10
(``chiprun_out/chip_smoke_dryrun.json``); ``11``, phases 1, 2 and 11
(``chiprun_out/chip_smoke_multidevice.json``); ``zamba2-7b-instruct``,
phases 1 and 2, phase 3's spm_matmul and flash cases at that model's
shapes, and phases 5 and 6 of its serve
(``chiprun_out/chip_smoke_zamba2-7b-instruct.json``).
"""
import functools
import gc
import json
import math
import os
import re
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              "tf32": 495e12}
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
    ptxas's register and spill lines and any line of its that reports
    the entry's wgmma serialised.  Fails if that line names a kernel of
    the tensor-core forward, whose design rests on its products
    overlapping (the source note of ``csrc/flash_attention.cu``)."""
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    logs = _build.build(_build.SOURCES + tuple(_build.VARIANTS),
                        ptxas_verbose=True)
    secs = time.monotonic() - t0
    print(f"phase 2 build: {sorted(_build.SOURCES)} and the variants "
          f"{sorted(_build.VARIANTS)} with {' '.join(_build.NVCC_FLAGS)} "
          f"in {secs:.1f} s (newly built: {sorted(logs)})", flush=True)
    usage, serialised = {}, []
    for name, text in logs.items():
        if name not in _build.SOURCES:
            continue
        entry = None
        for line in text.splitlines():
            if "Compiling entry function" in line and "'" in line:
                entry = line.split("'")[1]
            elif "wgmma" in line and "serialized" in line:
                # "... serialized due to <why> {in,for} the function
                # '<entry>'"
                fn = line.split("'")[-2] if line.count("'") >= 2 else entry
                why = re.split(r" (?:in|for) the function",
                               line.split("serialized", 1)[1])[0]
                usage.setdefault(fn, []).append(f"wgmma serialized{why}")
                serialised.append(fn)
            elif entry and ("registers" in line or "spill" in line):
                usage.setdefault(entry, []).append(
                    line.split(":", 1)[-1].strip())
    for entry, lines in usage.items():
        print(f"  {entry}: {'; '.join(lines)}")
    lost = sorted({fn for fn in serialised if "flash_fwd_tc" in fn})
    if lost:
        fail(f"ptxas serialised the wgmma of the tensor-core forward's "
             f"{lost}")
    return secs, usage


# ----------------------------------------------------------- kernels

def matmul_cases():
    """(label, m, k, n, trans_b, dtype, out_dtype, plan, main_path);
    the main path's shapes of qwen2-0.5b, of rwkv6-1.6b, of gemma3-12b
    (prefill M = 4 x 2048; the tied logits read the 262,144 x 3840
    table, 2.01 GB, in place), of zamba2-7b (prefill M = 4 x 512;
    in_proj's N = 14,576 leaves 48 columns past the split-K tiles and
    112 past the wgmma tiles), of zamba2-7b-instruct (the benchmark's
    batch of 32 and phase 5's of 4), of whisper-base (K = 512 at M = 6144 on
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
    # the benchmark's decode batches (portbench/workloads): rwkv6-1.6b's
    # seven products at 8 rows (the N = 8 form of split-K), pixtral-12b's
    # five at 16
    for what, k, n in (("r/k/v/g/o, cm r", rd, rd), ("cm k", rd, rff),
                       ("cm v", rff, rd), ("mix_w1", rd, 160),
                       ("mix_w2 (x5)", 32, rd), ("wd_w1", rd, 64),
                       ("wd_w2", 64, rd)):
        cases.append((f"rwkv decode B8 {what}", 8, k, n, False, bf, None, {},
                      True))
    for what, k, n in (("q proj", 5120, 4096), ("k/v proj", 5120, 1024),
                       ("o proj", 4096, 5120), ("gate/up", 5120, 14_336),
                       ("down", 14_336, 5120)):
        cases.append((f"pixtral decode B16 {what}", 16, k, n, False, bf, None,
                      {}, True))
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
    # zamba2-7b-instruct at the benchmark's batch (decode M = 32, on the
    # tiled kernel; prefill M = 32 x 1024) and at phase 5's (M = 4,
    # 4 x 1024): in_proj N = 2 x 7168 + 2 x 2 x 64 + 112 = 14,704, the
    # tied blocks' q/k/v from concat(x, x0), o (out_proj's shape), one
    # gate/up product and down, each hybrid layer's rank-128 adapter and
    # its linear; the logits against the tied embedding table
    for phase, m in (("decode B32", 32), ("prefill B32", 32 * 1024),
                     ("decode", B), ("prefill", B * 1024)):
        for what, k, n in (("in_proj", zd, 14_704),
                           ("out_proj, tied o", zi, zd),
                           ("tied q/k/v", zi, zi),
                           ("tied gate/up", zd, 2 * zff),
                           ("tied down", zff, zd), ("adapter A", zd, 128),
                           ("adapter B", 128, 2 * zff), ("linear", zd, zd)):
            cases.append((f"zamba2-7b-instruct {phase} {what}", m, k, n,
                          False, bf, None, {}, True))
        if phase.startswith("decode"):
            cases.append((f"zamba2-7b-instruct {phase} logits (embed^T)", m,
                          zd, zV, True, bf, f32, {}, True))
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
    # phase 11's full-width serves (prompt 256, prefill M = 4 x 256):
    # deepseek-67b and qwen2-72b at d 8192 (FFN 22,016 and 29,568),
    # qwen3-moe-235b-a22b's attention (64 heads of 128 over d 4096; its
    # experts are einsums), llama4-maverick-400b-a17b at d 5120 (dense
    # FFN 16,384, shared expert 8192); each one's logits, taken at the
    # last position (M = 4), against its own table (llama4's 202,048
    # rows padded to 202,112)
    for phase, m in (("decode", B), ("prefill", BP)):
        for what, k, n in (("d8192 q/o proj", 8192, 8192),
                           ("d8192 k/v proj", 8192, 1024),
                           ("deepseek gate/up", 8192, 22_016),
                           ("deepseek down", 22_016, 8192),
                           ("qwen2-72b gate/up", 8192, 29_568),
                           ("qwen2-72b down", 29_568, 8192),
                           ("qwen3-moe q proj", 4096, 8192),
                           ("qwen3-moe k/v proj", 4096, 512),
                           ("qwen3-moe o proj", 8192, 4096),
                           ("llama4 q/o proj", 5120, 5120),
                           ("llama4 k/v proj", 5120, 1024),
                           ("llama4 dense gate/up", 5120, 16_384),
                           ("llama4 dense down", 16_384, 5120),
                           ("llama4 shared gate/up", 5120, 8192),
                           ("llama4 shared down", 8192, 5120)):
            cases.append((f"{phase} {what}", m, k, n, False, bf, None, {},
                          True))
    for what, k, n in (("deepseek", 8192, 102_400),
                       ("qwen3-moe", 4096, 151_936),
                       ("qwen2-72b", 8192, 152_064),
                       ("llama4", 5120, 202_112)):
        cases.append((f"{what} logits (lm_head^T)", B, k, n, True, bf, f32,
                      {}, True))
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
             ("zamba2-7b-instruct tied-block prefill", 32, 1024, 1024, 32,
              32, 224, True, 0, bf, True),
             ("whisper encoder and cross prefill", 4, 1536, 1536, 8, 8, 64,
              False, 0, bf, True),
             ("whisper decoder self prefill", 4, 1536, 1536, 8, 8, 64,
              True, 0, bf, True),
             ("pixtral prefill", 4, 1024, 1024, 32, 8, 128, True, 0, bf,
              True),
             ("qwen3-moe prefill (group 16)", 4, 256, 256, 64, 4, 128, True,
              0, bf, True),
             ("deepseek, qwen2-72b prefill", 4, 256, 256, 64, 8, 128, True,
              0, bf, True),
             ("llama4 prefill", 4, 256, 256, 40, 8, 128, True, 0, bf, True),
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
             ("ragged S=100 D=224", 2, 100, 100, 8, 8, 224, True, 0, bf,
              False),
             ("fp32 D=224", 1, 256, 256, 4, 4, 224, True, 0, f32, False),
             ("unaligned bf16 D=224", 1, 128, 128, 4, 4, 224, True, 0, bf,
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


def run_matmul(dev, gen, only=""):
    """Phase 3's spm_matmul cases (those whose label starts with
    ``only``)."""
    from repro_torch.kernels.spm_matmul import ops
    from repro_torch.kernels.tolerance import ATOL_FRAC, RTOL, check
    rows = []
    for label, m, k, n, tb, dt, out, plan, main in [
            c for c in matmul_cases() if c[0].startswith(only)]:
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


def run_flash(dev, gen, only=""):
    """Phase 3's flash_attention cases (those whose label starts with
    ``only``)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.tolerance import ATOL_FRAC, RTOL, check
    rows = []
    for label, B, Sq, Sk, H, KV, D, causal, w, dt, main in [
            c for c in flash_cases() if c[0].startswith(only)]:
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


def eager_ms(fn, reps=5):
    """Device ms per call of ``fn()``, run eagerly between CUDA events
    after one warm-up call (for calls through autograd, which the graph
    capture of ``time_ms`` does not take)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_attention_bwd_ms(q, k, v, do, causal, window, mask):
    """The backward's yardstick: the gradient of
    ``scaled_dot_product_attention`` (as ``library_attention_ms`` calls
    it, the first of ``SDPA_BACKENDS`` that takes its forward and
    backward) against ``do``, timed alone; returns its ms and that
    backend's name."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel
    x, y, z = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in (q, k, v))
    g = do.transpose(1, 2).contiguous()
    kw = {"attn_mask": mask} if window else {"is_causal": causal}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel(backend):
                    out = F.scaled_dot_product_attention(
                        x, y, z, enable_gqa=True, **kw)
                    torch.autograd.grad(out, (x, y, z), g)
                    torch.cuda.synchronize()
            except RuntimeError:
                continue
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(x, y, z,
                                                     enable_gqa=True, **kw)
                ms = eager_ms(lambda: torch.autograd.grad(
                    out, (x, y, z), g, retain_graph=True))
            return ms, name.lower()
    return None, None


def flash_bwd_cases():
    """(label, B, Sq, Sk, H, KV, D, causal, window, dtype, main_path):
    phase 9(a)'s flash_attention backward cases.  The main path's:
    qwen2-0.5b's training shape (phase 9(c)), zamba2-7b's shared
    attention and qwen3-moe's group of 16 at phase 9(g)'s 4 x 1024.  Off
    it: gemma3-12b's local layer (head dim 256, window 1024) at batch 1,
    whisper's cross-attention shape (non-causal, Sq 448 != Sk 1500), fp32
    (the ``fma`` path, as phases 9(b) and 9(e) train), bf16 off the
    16-byte grid (``fma`` in bf16) and a ragged window."""
    bf, f32 = torch.bfloat16, torch.float32
    return [("qwen2-0.5b train", 4, 4096, 4096, 14, 2, 64, True, 0, bf,
             True),
            ("zamba2-7b train (shared attention)", 4, 1024, 1024, 32, 32,
             112, True, 0, bf, True),
            ("qwen3-moe train (group 16)", 4, 1024, 1024, 64, 4, 128, True,
             0, bf, True),
            ("gemma3 local, batch 1", 1, 2048, 2048, 16, 8, 256, True, 1024,
             bf, False),
            ("cross Sq 448 Sk 1500", 2, 448, 1500, 8, 8, 64, False, 0, bf,
             False),
            ("fp32", 2, 256, 256, 4, 2, 64, True, 0, f32, False),
            ("fp32 D=256 window 64", 1, 256, 256, 4, 2, 256, True, 64, f32,
             False),
            ("unaligned bf16 D=112", 1, 200, 200, 4, 2, 112, True, 0, bf,
             False),
            ("ragged S=100 D=32 window 24", 2, 100, 100, 4, 1, 32, True, 24,
             bf, False)]


# the backward's launches by the kernel names a profile shows
FLASH_BWD_LAUNCHES = {"dq": "flash_bwd_dq", "dkdv": "flash_bwd_dkdv",
                      "group sum": "flash_bwd_group_sum"}


def flash_bwd_launch_ms(fn, reps=3):
    """Device ms per call of each of the backward's launches
    (``FLASH_BWD_LAUNCHES``): each kernel's mean over the launches a
    profile of ``reps`` calls of ``fn()`` (after one warm-up) recorded
    (one a call); a launch that did not run reads 0."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(FLASH_BWD_LAUNCHES, 0.0)
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        for name, pattern in FLASH_BWD_LAUNCHES.items():
            if pattern in ev.key:
                out[name] += t / 1e3 / max(ev.count, 1)
    return out


def flash_bwd_products(path, D):
    """The products a visible pair that a backward path runs: in the dQ
    launch S, dP and dQ (on ``tensor_core`` as two bf16 parts), and S
    and dP in a walk for D_i before them (``fma``; ``tensor_core`` at
    head dim 256, where the forward writes no o_lo); in the dK/dV launch
    S, dP, dV and dK, its two ``tensor_core`` warpgroups above head dim
    64 each running S and dP over the same keys."""
    if path == "tensor_core":
        return 8 + (2 if D > 64 else 0) + (2 if D > 128 else 0)
    return 9


def run_flash_bwd(dev, gen):
    """flash_attention's backward (``csrc/flash_attention_bwd.cu``) at
    ``flash_bwd_cases``: the forward's o the same bits with and without
    its lse and o_lo, that lse against the plain forward's, o + o_lo
    against the tensor-core forward's full fp32 output by its arithmetic
    in plain torch (``ref.attention_tc_fp32``: its RMS difference under a
    tenth of o's alone), and the forward's time with and without them;
    the backward on the path ``ops.bwd_dispatch`` routes it to, each of
    dq, dk and dv held to ``attention_grad`` evaluated in fp32 on the
    same inputs
    (``tolerance.check_flash_grad``), run twice for the same bits, its
    planted faults caught (``tolerance.flash_bwd_planted_faults``); the
    kernel's time and each of its launches' (a profile), the plain
    version's (``attention_grad`` on the case's dtype, as the CPU route
    runs it), SDPA's backward and the bound: the five products, 10 D x
    visible pairs x B x H, at the dtype's rate, and q, k, v, do and lse
    read and dq, dk and dv written once; beside it the products a pair
    the path runs."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                         attention_tc_fp32)
    from repro_torch.kernels.tolerance import (ATOL_FRAC, RTOL, check,
                                               check_flash_grad,
                                               flash_bwd_planted_faults)
    rows = []
    for label, B, Sq, Sk, H, KV, D, causal, w, dt, main in \
            flash_bwd_cases():
        off = int(label.startswith("unaligned"))
        q, k, v, do = (torch.randn(B, s, n, D + off, generator=gen,
                                   device=dev).to(dt)[..., off:]
                       for s, n in ((Sq, H), (Sk, KV), (Sk, KV), (Sq, H)))
        scale = 1.0 / math.sqrt(D)
        kw = {"causal": causal, "window": w, "scale": scale}
        o, lse, o_lo = ops._launch(q, k, v, causal, w, scale, with_lse=True)
        if not torch.equal(o, ops._launch(q, k, v, causal, w, scale)):
            fail(f"flash_attention {label}: o differs with and without lse")
        lse_ratio, _ = check(lse, attention_ref(q, k, v, with_lse=True,
                                                **kw)[1], torch.float32)
        if not lse_ratio < 1:
            fail(f"flash_attention {label}: lse at {lse_ratio:.3f} of the "
                 f"fp32 allowance")
        lo_share = None
        if o_lo is not None:
            _, full, _ = attention_tc_fp32(q, k, v, **kw)
            lo_share = ((o.float() + o_lo.float() - full).pow(2).mean()
                        / (o.float() - full).pow(2).mean()).sqrt().item()
            del full
            if not lo_share < 0.1:
                fail(f"flash_attention {label}: o + o_lo misses the fp32 "
                     f"output by {lo_share:.3f} of o's RMS error")
        fwd_ms = {
            "plain launch": time_ms(lambda *a: ops._launch(
                *a, causal, w, scale), [(q, k, v)], min_reps=5),
            "with lse and o_lo": time_ms(lambda *a: ops._launch(
                *a, causal, w, scale, with_lse=True), [(q, k, v)],
                min_reps=5)}
        # the backward, fed the forward's o and o_lo for its D_i
        bwd = functools.partial(ops.attention_bwd, o=o, o_lo=o_lo)
        before = dict(ops.attention.bwd_paths)
        got = bwd(q, k, v, lse, do, **kw)
        torch.cuda.synchronize()
        path = launched_path(ops.attention.bwd_paths, before)
        want_path = "tensor_core" if dt == torch.bfloat16 and not off \
            else "fma"
        if path != want_path:
            fail(f"flash_attention_bwd {label}: launched {path}, expected "
                 f"{want_path}")
        again = bwd(q, k, v, lse, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd {label}: two runs differ")
        del again
        want = ops.attention_grad(*(t.float() for t in (q, k, v, do)), **kw)
        ratio, diff, shares = check_flash_grad(got, want, dt)
        if not all(torch.isfinite(g).all() for g in got) or not ratio < 1:
            fail(f"flash_attention_bwd {label}: error at {shares} of its "
                 f"allowance")
        faults = {
            name: check_flash_grad(wrong, want, dt)[0]
            for name, wrong in flash_bwd_planted_faults(
                bwd, q, k, v, lse, do, **kw).items()}
        if not min(faults.values()) > 1:
            fail(f"flash_attention_bwd {label}: a planted fault passes: "
                 f"{faults}")
        del got, want
        mask = mask_of(Sq, Sk, causal, w, dev)
        pairs = int(mask.sum())
        row = {"kernel": "flash_attention_bwd", "case": label,
               "shape": [B, Sq, Sk, H, KV, D], "causal": causal,
               "window": w, "dtype": str(dt), "path": path,
               "deterministic": True, "err_ratio": ratio,
               "err_shares": shares, "fault_ratios": faults,
               "lse_ratio": lse_ratio, "o_lo_rms_share": lo_share,
               "max_abs_err": diff,
               "rtol": RTOL[dt], "atol_frac": ATOL_FRAC[dt],
               "main_path": main, "pairs_per_head": pairs,
               "products_per_pair": flash_bwd_products(path, D),
               "bound_products_per_pair": 5}
        row["ms"] = time_ms(lambda *a: bwd(*a, **kw),
                            [(q, k, v, lse, do)], min_reps=5)
        row["launch_ms"] = flash_bwd_launch_ms(
            lambda: bwd(q, k, v, lse, do, **kw))
        row["plain_ms"] = eager_ms(lambda: ops.attention_grad(q, k, v, do,
                                                              **kw), reps=2)
        row["forward_ms"] = fwd_ms
        row["library_ms"], row["library_backend"] = \
            library_attention_bwd_ms(q, k, v, do, causal, w, mask)
        nbytes = (3 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 10 * D * pairs * B * H, dt)
        rows.append(row)
        per_grad = ", ".join(f"{n} {r:.3f}" for n, r in shares.items())
        per_fault = ", ".join(f"{n} {r:.1f}" for n, r in faults.items())
        per_launch = ", ".join(f"{n} {t:.4f}"
                               for n, t in row["launch_ms"].items())
        lo = "" if lo_share is None else f"; o_lo rms {lo_share:.4f}"
        print(f"  flash_attention_bwd {label:34s} B{B} Sq{Sq} Sk{Sk} H{H} "
              f"KV{KV} D{D} causal={causal} window={w} {str(dt)[6:]:8s} "
              f"{path} err {ratio:.3f} of allowance ({per_grad}; lse "
              f"{lse_ratio:.3f}{lo}) faults {per_fault}  "
              f"kernel {row['ms']:.4f} ms ({per_launch}; "
              f"{row['products_per_pair']} products a pair, the bound's 5)"
              f"  plain {row['plain_ms']:.4f} ms  forward "
              + "/".join(f"{t:.4f}" for t in fwd_ms.values())
              + f" ms (plain/with lse and o_lo)  library "
              f"{row['library_ms']} ms (SDPA backward "
              f"{row['library_backend']})  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        del q, k, v, do, lse, mask, o, o_lo, bwd
        release()
    return rows


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


def wkv_bwd_cases():
    """(label, B, S, H, K, dtype, decay, with dS_T, main_path): the
    backward at rwkv6-1.6b's training shape (TRAIN_4K's sequence, batch
    cut to 4; run on its routed path and again on the ``fma`` path) and
    at the serve shape, an fp32 case with the final state's gradient, a
    ragged S, more than one group of a cluster (S 1,100 at B * H 2; S
    600 at K 32, ragged too), and K 32, 64 (the reference's conformance
    shapes) and 128."""
    from repro_torch.kernels import CONFORMANCE_SHAPES
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("train", TRAIN_B, TRAIN_S, 32, 64, bf, "model", False, True),
             ("serve shape", 4, 256, 32, 64, bf, "model", False, False),
             ("fp32, dS_T", 2, 256, 4, 64, f32, "model", True, False),
             ("ragged S=100", 2, 100, 2, 64, bf, "model", True, False),
             ("groups, S=1100", 1, 1100, 2, 64, bf, "model", True, False),
             ("K=32, S=600", 2, 600, 4, 32, bf, "model", True, False),
             ("K=128", 2, 256, 4, 128, bf, "model", False, False)]
    for b, s, h, k, _, dt in CONFORMANCE_SHAPES["wkv6"]:
        cases.append(("conformance", b, s, h, k, getattr(torch, dt),
                      "reference", True, False))
    return cases


def run_wkv_bwd(dev, gen):
    """wkv6's backward (``csrc/wkv6_bwd.cu``) against its plain version
    (``ops.wkv_grad_plain``: autograd through the exact recurrence)
    gradient by gradient (``tolerance.check_wkv_grad``), each case on
    the path ``ops.bwd_dispatch`` routes it to (checked against the
    wrappers' path counts) and the training shape on the ``fma`` path
    too: run twice for the same bits, with the backward's planted faults
    caught (the two at a cluster's group boundary where the
    ``tensor_core`` route walks more than one group; the forced ``fma``
    run is held to the same five); then its time, the plain version's
    (CUDA events around the checked call: autograd's loop over every
    position is not captured), the byte and the operations bound, and
    at the training shape each path's step shares (``wkv6_bwd_steps``)."""
    from repro_torch.core.gpu_mapping import WKV_BWD_ROWS
    from repro_torch.kernels.tolerance import (allowance, check_wkv_grad,
                                               wkv_bwd_planted_faults,
                                               wkv_inputs)
    from repro_torch.kernels.wkv6 import ops
    rows = []
    for label, B, S, H, K, dt, decay, with_ds, main in wkv_bwd_cases():
        args = wkv_inputs(B, S, H, K, dt, decay, gen, dev)
        dy = torch.randn(B, S, H, K, generator=gen, device=dev).to(dt)
        ds = (0.1 * torch.randn(B, H, K, K, generator=gen, device=dev)
              if with_ds else None)
        route = ops.bwd_dispatch(S, K, dt, True, B * H)
        tc = ops.bwd_dispatch(S, K, torch.bfloat16, True, B * H)
        group = tc["rows"] * tc["cluster"] if tc["groups"] > 1 else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = ops.wkv_grad_plain(*args, dy, ds)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        runs = [(route["path"], None)]
        if main and route["path"] != "fma":
            runs.append(("fma", ops.bwd_dispatch(S, K, torch.float32)))
        for path, force in runs:
            def bwd(*a, force=force):
                if force is None:
                    return ops.wkv_bwd(*a)
                return ops._bwd_launch(force, *a)
            before = dict(ops.wkv.bwd_paths)
            got = bwd(*args, dy, ds)
            torch.cuda.synchronize()
            if launched_path(ops.wkv.bwd_paths, before) != path:
                fail(f"wkv6 backward {label}: launched "
                     f"{ops.wkv.bwd_paths} from {before}, expected {path}")
            again = bwd(*args, dy, ds)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"wkv6 backward {label} ({path}): two runs differ")
            del again
            ratio, diff, shares = check_wkv_grad(got, want, dt)
            if not (all(torch.isfinite(g).all() for g in got) and ratio < 1):
                fail(f"wkv6 backward {label} ({path}): error at {ratio:.3f} "
                     f"of its allowance ({shares})")
            L = tc["rows"] if path == "tensor_core" else WKV_BWD_ROWS[K]
            faults = {name: check_wkv_grad(f, want, dt)[0]
                      for name, f in wkv_bwd_planted_faults(
                          bwd, *args, dy, ds, L if S > L else S // 2,
                          group).items()}
            for name, fault in faults.items():
                if not fault > 1:
                    fail(f"wkv6 backward {label} ({path}): the check misses "
                         f"'{name}' ({fault:.3f} of its allowance)")
            atol_frac, rtol = allowance(torch.float32, "wkv6_bwd")
            used = route if force is None else force
            row = {"kernel": "wkv6_bwd", "case": label,
                   "shape": [B, S, H, K], "path": path,
                   "rows": used["rows"], "cluster": used["cluster"],
                   "groups": used["groups"],
                   "segments": used.get("segments"), "dtype": str(dt),
                   "decay": decay, "dstate": with_ds, "deterministic": True,
                   "err_ratio": ratio, "err_shares": shares,
                   "fault_ratio": min(faults.values()), "faults": faults,
                   "max_abs_err": diff, "fp32_rtol": rtol,
                   "fp32_atol_frac": atol_frac,
                   "main_path": main and force is None}
            ins = args + (dy,) + ((ds,) if with_ds else ())
            nbytes = (sum(t.numel() * t.element_size() for t in ins)
                      + sum(g.numel() * g.element_size() for g in got))
            copies = max(1, min(8, math.ceil(2 * L2_BYTES / nbytes)))
            sets = [args + (dy, ds)] + [
                tuple(None if t is None else t.clone()
                      for t in args + (dy, ds)) for _ in range(copies - 1)]
            del got
            row["ms"] = time_ms(bwd, sets, min_reps=5)
            row["plain_ms"] = plain_ms
            row["library_ms"] = None    # no one PyTorch call computes it
            # five [K, K] products a row: the state update, S dy, dS v,
            # k dS and r^T dy; each input read once, each gradient written
            # once.  fma takes them at the fp32 rate; tensor_core on
            # mma.sync in tf32, k dS (dv's) in one pass and the other four
            # in three (an operand split in two), 13 passes for 5 products
            flops, rate = ((10 * B * S * H * K * K, torch.float32)
                           if path == "fma"
                           else (26 * B * S * H * K * K, "tf32"))
            row["bytes_bound_ms"] = bound(nbytes, 0, rate)[0]
            row["ops_bound_ms"] = bound(0, flops, rate)[0]
            row["bound_ms"], row["bound_by"] = bound(nbytes, flops, rate)
            if main:
                row["step_shares"] = wkv_bwd_step_shares(args, dy, path,
                                                         used)
            if main and path == "tensor_core":
                row["design_ms"] = wkv_bwd_design_ms(bwd, sets, used)
            del sets
            rows.append(row)
            print(f"  wkv6_bwd {label:14s} B{B} S{S} H{H} K{K} "
                  f"{str(dt)[6:]} {decay} decay{', dS_T' if with_ds else ''}"
                  f", {path}, {used['rows']}-row chunks, cluster "
                  f"{used['cluster']} x {used['groups']} groups: err "
                  f"{ratio:.3f} of allowance ("
                  + ", ".join(f"{n} {v:.3f}" for n, v in shares.items())
                  + "; faults " + ", ".join(f"{n} {f:.1f}"
                                            for n, f in faults.items())
                  + f")  max abs {diff:.2e}  kernel {row['ms']:.4f} ms  "
                  f"plain {row['plain_ms']:.4f} ms  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
                  f"{row['bytes_bound_ms']:.4f}, operations "
                  f"{row['ops_bound_ms']:.4f}); library: none", flush=True)
            if "design_ms" in row:
                print("    wkv6_bwd tensor_core design choices at this "
                      "shape, timed in turn (ms): " + ", ".join(
                          f"{n} {v:.4f}" for n, v in row["design_ms"].items()),
                      flush=True)
            if main:
                print(f"    wkv6_bwd {path} step shares of a block's cycles "
                      "(clock64, WKV6_BWD_STEP_CLOCKS build): " + ", ".join(
                          f"{n} {v:.3f}" if v < 1 else f"{n} {v:,.0f}"
                          for n, v in row["step_shares"].items()),
                      flush=True)
        del want
        release()
    return rows


def wkv_bwd_design_ms(bwd, sets, route):
    """The ``tensor_core`` backward on ``route`` timed against the two
    choices its design rests on, in turn in this run: the wrapper's
    library (gradient kernels compiled for clusters of up to 2 where the
    cluster is that small), the same route at the largest cluster
    (``_bwd_launch``), and the library whose gradient kernels are
    compiled for clusters of up to 8 alone (``wkv6_bwd_cmax8``) at the
    route's cluster, which must give the wrapper's bits; then the
    wrapper's again, for the spread."""
    import ctypes

    from repro_torch.core.gpu_mapping import WKV_MAX_CLUSTER
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import ops
    lib = _build.load("wkv6_bwd_cmax8")
    name, argtypes = ops.BWD_ENTRIES["tensor_core"]
    launch = getattr(lib, name)
    launch.argtypes = argtypes
    launch.restype = ctypes.c_int

    def cmax8(r, k, v, w, u, dy, ds):
        B, S, H, K = r.shape
        outs = [torch.empty_like(r) for _ in range(3)] + [torch.empty_like(w)]
        du = torch.empty(B * H, route["cluster"] * route["groups"], K,
                         device=r.device)
        scratch = torch.empty(B * H * (route["groups"] + route["segments"])
                              * K * (K + 1), device=r.device)
        err = launch(*(t.data_ptr() for t in (r, k, v, w, u, dy)),
                     None if ds is None else ds.data_ptr(),
                     *(t.data_ptr() for t in outs), du.data_ptr(),
                     scratch.data_ptr(), B, S, H, K, route["rows"],
                     route["cluster"], route["segments"],
                     torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"wkv6 backward (wkv6_bwd_cmax8): launch failed ({err})")
        return (*outs[:3], outs[3], du.sum(1).view(B, H, K).sum(0))

    want, got = bwd(*sets[0]), cmax8(*sets[0])
    if not all(torch.equal(a, b) for a, b in zip(want, got)):
        fail("wkv6 backward: the wkv6_bwd_cmax8 build's bits differ")
    del want, got
    chunks = -(-sets[0][0].shape[1] // route["rows"])
    wide = min(WKV_MAX_CLUSTER, chunks)
    groups = -(-chunks // wide)
    wide_route = dict(route, cluster=wide, groups=groups,
                      segments=min(route["segments"], groups))
    out = {f"cluster {route['cluster']}": time_ms(bwd, sets, min_reps=5)}
    out[f"cluster {wide}"] = time_ms(
        lambda *a: ops._bwd_launch(wide_route, *a), sets, min_reps=5)
    out[f"cluster {route['cluster']}, cmax8 build"] = time_ms(
        cmax8, sets, min_reps=5)
    out[f"cluster {route['cluster']} again"] = time_ms(bwd, sets, min_reps=5)
    return out


WKV_BWD_STEPS = {
    "tensor_core": ("loads", "scan", "kd, r exp2(e), g, r u k",
                    "contributions, dy v^T", "first cluster barrier",
                    "folds", "second cluster barrier", "k', r~",
                    "diagonal sub-tiles, A", "dr, dk", "kd, scan sums",
                    "dv, dw, du"),
    "fma": ("forward: loads", "forward: cumsum, decayed keys",
            "forward: state update", "loads", "cumsum, Q, g, r u k",
            "A, dy.v", "dr", "dk", "dw, du", "decayed r and k", "dv",
            "dS update")}


def wkv_bwd_step_shares(args, dy, path, route):
    """Each step's share of the cycles of ``path``'s gradient kernel's
    blocks on ``args``, the cycles of a block (and on ``tensor_core``
    of a states-launch block), from the ``wkv6_bwd_steps`` build
    (thread 0 of each block reads clock64 as each step ends).
    Launched through that library's own C entries: the wrappers' counts
    do not move."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import ops
    lib = _build.load("wkv6_bwd_steps")
    name, argtypes = ops.BWD_ENTRIES[path]
    launch = getattr(lib, name)
    launch.argtypes = argtypes
    launch.restype = ctypes.c_int
    read = lib.wkv6_bwd_step_clocks
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    r = args[0]
    B, S, H, K = r.shape
    outs = [torch.empty_like(r) for _ in range(3)] + [torch.empty_like(args[3])]
    if path == "tensor_core":
        du = torch.empty(B * H, route["cluster"] * route["groups"], K,
                         device=r.device)
        scratch = torch.empty(B * H * (route["groups"] + route["segments"])
                              * K * (K + 1), device=r.device)
        extra = (route["cluster"], route["segments"])
    else:
        du = torch.empty(B, H, K, device=r.device)
        scratch = torch.empty(B * H * (-(-S // route["rows"]) + 1) * K * K,
                              device=r.device)
        extra = (int(r.dtype == torch.bfloat16),)
    n_tc, n_fma = (len(WKV_BWD_STEPS[p]) for p in ("tensor_core", "fma"))
    states = n_tc + n_fma       # the slots of csrc/wkv6_bwd.cu's counters
    counts = (ctypes.c_ulonglong * (states + 4))()
    for _ in range(2):          # the first run warms up
        if read(counts):
            fail("wkv6 backward step clocks: read failed")
        err = launch(*(t.data_ptr() for t in args), dy.data_ptr(), None,
                     *(t.data_ptr() for t in outs), du.data_ptr(),
                     scratch.data_ptr(), B, S, H, K, route["rows"], *extra,
                     torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            fail(f"wkv6 backward step clocks: launch failed ({err})")
    if read(counts):
        fail("wkv6 backward step clocks: read failed")
    first, blocks = ((0, states + 1) if path == "tensor_core"
                     else (n_tc, states + 2))
    steps = WKV_BWD_STEPS[path]
    total = sum(counts[first:first + len(steps)])
    shares = {n: counts[first + i] / total for i, n in enumerate(steps)}
    shares["cycles per block"] = total / counts[blocks]
    if path == "tensor_core":
        shares["states cycles per block"] = counts[states] / counts[states + 3]
    return shares


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
    rows = (run_matmul(dev, gen) + run_flash(dev, gen) + run_wkv(dev, gen)
            + run_wkv_bwd(dev, gen))
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


def reduced_model(arch):
    """Phase 4's reduced fp32 ``arch`` (``MODELS``' layers, d 128, vocab
    512) and its parameters drawn on the CPU from seed 0: the RWKV bonus
    and token-shift mixes made non-zero, tied-block, encoder and
    cross-attention q/k at their inputs' fan-in."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_items

    cfg = reduce_config(get_config(arch), layers=MODELS[arch], d_model=128,
                        vocab=512)
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.attention and cfg.attention.sliding_window:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, sliding_window=REDUCED_WINDOW))
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
    return cfg, cpu_params


def phase_model(dev, arch):
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_map

    cfg, cpu_params = reduced_model(arch)
    B, P, G = 2, 64, 8
    opts = lm.RunOptions(chunk_q=32, chunk_kv=32, cache_len=P + G,
                         remat=False)
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
    # the published form, at the benchmark cell's prompt of 1024 (four
    # SSD chunks of 256): 81 mamba layers of 2 products, 13 tied-block
    # applications of 9 (q, k, v, o, gate/up, the adapter's two, down,
    # the layer's linear) and one flash launch each at head dim 224
    "zamba2-7b-instruct": {"prompt": 1024, "vocab": 32_000,
                           "kernels": ("spm_matmul", "flash_attention"),
                           "per_prefill": {"spm_matmul": 81 * 2 + 13 * 9 + 1,
                                           "flash_attention": 13},
                           "mm_per_step": 81 * 2 + 13 * 9 + 1},
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
# prefill graph replays timed per served arch (3 for phase 11's), greedy
# tokens compared between the graphs and eager calls
PREFILL_REPLAYS = {"qwen2-0.5b": 10, "rwkv6-1.6b": 10, "gemma3-12b": 3,
                   "zamba2-7b": 3, "zamba2-7b-instruct": 3,
                   "whisper-base": 10, "pixtral-12b": 3}
PARITY_TOKENS = 8


def serve_argv(arch):
    want = serve_want(arch)
    return ["--arch", want.get("arch", arch), "--full", "--batch", "4",
            "--prompt-len", str(want["prompt"]), "--gen", str(G),
            "--device", "cuda"]


def serve_want(key):
    """What a served key must do: phase 5's ``SERVES`` or phase 11's
    ``WIDE_SERVES``."""
    return SERVES[key] if key in SERVES else WIDE_SERVES[key]


def serve_cfg(key):
    """The config a served key serves: its arch, at the depth phase 11
    cuts it to."""
    import dataclasses
    from repro_torch.configs import get_config
    if key in SERVES:
        return get_config(key)
    want = WIDE_SERVES[key]
    return dataclasses.replace(get_config(want["arch"]),
                               num_layers=want["layers"])


def release():
    """Hand the last phase's device memory back before the next."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(arch):
    """One served key through the launcher: phase 5's models through
    ``serve.main`` (the command line), phase 11's through ``serve.serve``
    on the config cut to its depth (``serve_cfg``), as a caller with a
    ``ModelConfig`` serves it.  The launch counters are zeroed just
    before and read just after, the peak device memory likewise."""
    from repro_torch import compat
    from repro_torch.launch import serve

    want = serve_want(arch)
    phase = want.get("phase", 5)
    argv = serve_argv(arch)
    how = ("repro_torch.launch.serve" if arch in SERVES else
           f"repro_torch.launch.serve.serve(dataclasses.replace(get_config("
           f"{want['arch']!r}), num_layers={want['layers']}), args)")
    print(f"phase {phase} serve: {how} {' '.join(argv)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if arch in SERVES:
        res = serve.main(argv)
    else:
        res = serve.serve(serve_cfg(arch),
                          serve.build_parser().parse_args(argv),
                          compat.resolve_device("cuda"))
    launches = serve.launch_counts()
    paths = path_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    replayed = res["replayed_launches"]
    print(f"phase {phase} serve {arch}: wrapper launches {launches}; "
          f"launched by the timed prefill graph's replay "
          f"{res['prefill_launches']}; by the timed decode graph's replays "
          f"{replayed}", flush=True)
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
    j = res["jitter"]
    print(f"phase {phase} serve {arch}: ok, {toks.shape[0]}x{toks.shape[1]} "
          f"tokens in [0, {want['vocab']}), prefill "
          f"{res['prefill_s'] * 1e3:.3f} ms (one graph replay); decode "
          f"ms/step median {j['median'] * 1e3:.4f}, p99 "
          f"{j['p99'] * 1e3:.4f}, CoV {j['cov']:.4f}, WCET margin "
          f"{j['wcet_margin']:.4f}; peak memory {peak_gib:.2f} GiB "
          f"(max_memory_allocated, the init's included)", flush=True)
    shares = serve_flop_shares(arch, res)
    print(f"phase {phase} serve {arch}: model FLOPs as a share of 989 "
          f"TFLOP/s: the reference's analysis.flops.model_flops (2 x "
          f"active params x tokens) prefill "
          f"{shares['reference_prefill']:.4f}, decode step (median) "
          f"{shares['reference_decode']:.4f}; launch/train.py's "
          f"dense-decoder count (params x tokens + causal attention) over "
          f"3, the forward's, prefill {shares['port_prefill'] or '-'}",
          flush=True)
    if arch == "qwen2-0.5b":
        traced_serve(arch, argv, res)
    return launches, dict(res, paths=paths, flop_shares=shares,
                          peak_gib=peak_gib)


def traced_serve(arch, argv, res):
    """The same serve again with ``REPRO_TRACE`` set, for its trace file
    alone: on the card it replays graphs with their module spans, so
    its times stay out of the report.  Prints its decode median and
    prefill beside the plain serve's (``res``)."""
    from repro_torch.launch import serve
    print(f"phase 5 serve: REPRO_TRACE={SERVE_TRACE} "
          f"repro_torch.launch.serve {' '.join(argv)}", flush=True)
    SERVE_TRACE.unlink(missing_ok=True)
    os.environ["REPRO_TRACE"] = str(SERVE_TRACE)
    try:
        traced = serve.main(argv)
    finally:
        os.environ.pop("REPRO_TRACE", None)
    print(f"phase 5 serve {arch} with REPRO_TRACE (stamped graphs, not "
          f"in the report): decode ms/step median "
          f"{np.median(traced['decode_s']) * 1e3:.4f} against "
          f"{np.median(res['decode_s']) * 1e3:.4f} plain, prefill "
          f"{traced['prefill_s'] * 1e3:.3f} ms against "
          f"{res['prefill_s'] * 1e3:.3f}; deadline overruns "
          f"{traced['deadline']['overruns']}", flush=True)
    if not np.array_equal(np.stack(traced["tokens"]),
                          np.stack(res["tokens"])):
        fail(f"{arch}: the traced serve's tokens differ from the plain "
             f"serve's")


def serve_flop_shares(arch, res):
    """A served model's prefill and median decode step as shares of the
    bf16 peak under the reference's ``model_flops`` (batch 4, the
    prompt), and the prefill under the forward third of
    ``launch/train.py``'s count for a dense decoder (it counts every
    layer's attention and every prompt token; None for the other
    families)."""
    import dataclasses
    from repro_torch.analysis.flops import model_flops
    from repro_torch.configs import SHAPES
    from repro_torch.launch import train
    cfg, P = serve_cfg(arch), serve_want(arch)["prompt"]
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


def phase_capture(dev, arch, timing=True, phase=5, traces=None,
                  probe=None):
    """The serve's model, weights and prompt again (``serve.setup_model``,
    seed 0, the plan the serve resolves) through
    ``serve.compile_step_fns``: the prefill graph's logits against an
    eager ``lm.prefill``'s (bit for bit), greedy tokens through the two
    graphs against eager calls, then (``timing``) the prefill graph's
    replays timed by CUDA events, and the traces of phase 6 (``traces``:
    which graphs, by default the decode graph and, for gemma3-12b and
    both zamba2s, the prefill graph; ``probe(cfg, params)``, if given,
    returns the trace's families and what it read)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    args = serve.build_parser().parse_args(serve_argv(arch))
    cfg = serve_cfg(arch)
    _, _, opts, params, batch = serve.setup_model(cfg, args, dev)
    P, V = args.prompt_len, cfg.vocab_size
    families, probed = (TRACE_FAMILIES, None) if probe is None \
        else probe(cfg, params)

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
        check_padded_logits(arch, cfg, phase, captured,
                            step(graph_toks[:, -1].to(dev),
                                 P + PARITY_TOKENS - 1))
    del eager, cache
    release()
    if not timing:
        return {}

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replay_ms = []
    for _ in range(PREFILL_REPLAYS.get(arch, 3)):
        start.record()
        prefill_fn(batch)
        end.record()
        torch.cuda.synchronize()
        replay_ms.append(start.elapsed_time(end))
    tok = graph_toks[:, -1].to(dev)
    if traces is None:
        traces = ("decode", "prefill") if arch in (
            "gemma3-12b", "zamba2-7b", "zamba2-7b-instruct") else ("decode",)
    trace_phase = 6 if phase == 5 else phase
    out = {"prefill_replay_ms": replay_ms, "probe": probed}
    if "decode" in traces:
        out["decode_trace"] = trace_replays(
            f"{arch} decode step (graph replay, batch 4, {P}-token "
            f"prompt)", lambda i: step(tok, P + PARITY_TOKENS + i), 3,
            phase=trace_phase, families=families)
    if "prefill" in traces:
        out["prefill_trace"] = trace_replays(
            f"{arch} prefill (graph replay, 4 x {P} tokens)",
            lambda i: prefill_fn(batch), 1, phase=trace_phase,
            families=families)
    return out


def check_padded_logits(arch, cfg, phase, prefill_logits, decode_logits):
    """A padded vocabulary's tail, after the prefill replay and after a
    decode replay: every padded logit exactly -1e30, and no argmax over
    the whole padded row there."""
    V = cfg.vocab_size
    for what, logits in (("prefill", prefill_logits),
                         ("decode", decode_logits)):
        tail = logits[:, V:]
        masked = bool((tail == -1e30).all())
        top = int(torch.argmax(logits, dim=-1).max())
        print(f"phase {phase} capture {arch}: {what} replay's padded logits "
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
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
            count[e.name] = count.get(e.name, 0) + 1 / n
    patterns = families
    families = dict.fromkeys([f for f, _ in patterns] + ["other"], 0.0)
    launches = dict.fromkeys(families, 0.0)
    for name, ms in by_name.items():
        fam = next((f for f, pats in patterns
                    if any(p in name for p in pats)), "other")
        families[fam] += ms
        launches[fam] += count[name]
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
            "families_launches": launches, "top_kernels_ms": dict(top)}


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
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M"}
    replays = {e["args"]["replay"] for e in doc["traceEvents"]
               if e["ph"] == "X" and tracks[e["tid"]] == "device.decode"}
    print(f"phase 7 predictability: its device.decode track holds the "
          f"module spans of {len(replays)} decode replays", flush=True)
    if len(replays) != G:
        fail(f"qwen2's REPRO_TRACE file holds the module spans of "
             f"{len(replays)} decode replays, expected {G}")
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
    want = serve_want(arch)
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
    phase = 8 if tuned else want.get("phase", 5)
    print(f"phase {phase} serve {arch}: kernel paths {paths} (2 prefills "
          f"and 2 decode steps through the wrappers; launch_plan gives "
          f"{planned})", flush=True)
    if launches != expect:
        fail(f"{arch}: wrapper launches {launches}, expected {expect}: "
             f"something timed ran eagerly")
    if paths["spm_matmul"] != expect_paths:
        fail(f"{arch}: spm_matmul paths {paths['spm_matmul']}, expected "
             f"{expect_paths}")
    if sum(paths["wkv6_bwd"].values()):
        fail(f"{arch}: serving launched wkv6's backward kernel")
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
    from repro_torch.kernels.spm_matmul import ops
    counts = dict.fromkeys(ops.matmul.paths, 0)
    for m, k, n, tb, c, pinned in serve_products(
            serve_cfg(arch), 4, serve_want(arch)["prompt"]):
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
# phase 9(e): phase 4's reduced fp32 families whose gradients the card
# must give as the CPU does, as 9(b), the losses at FAMILY_GRAD_LR: at
# 9(b)'s 1e-2, gradients perturbed by NOISE_REL of each leaf's largest
# magnitude move these models' 5 CPU losses by more than GRAD_TOL (Adam
# turns a near-zero gradient's sign into a whole step), which is what
# the comparison would then read, not the card; the phase prints that
# spread at both rates
FAMILY_GRADS = ("rwkv6-1.6b", "zamba2-7b", "qwen3-moe-235b-a22b")
FAMILY_GRAD_LR = 1e-4
NOISE_REL = 1e-6
# phase 9(f) and (g): full width, bf16, batch TRAIN_B, AdamW at the
# launcher's lr, the update donated (written into the state, as the
# reference's jit donates it: qwen3-moe's 37 GB of state has no room
# for a second copy), through ``train.train``: (arch, layers (None: all), seq,
# steps, remat, warm-up steps: 2, so that the peak rate is reached
# while the steps last; whether the last loss, on a new batch, must be
# below the first: (g)'s 6 steps of 4 x 1024 tokens cover a few
# thousand of the 32,000 and 151,936 tokens whose permutation the
# Markov data follows, so a new batch's loss moves by about the spread
# between batches, and only the first batch's fall is held).  rwkv6-1.6b: TRAIN_4K's sequence at its full 24 layers;
# its step holds ~19 GB of state (bf16 parameters and gradients, fp32
# moments of 1.6 B parameters) and, without remat, ~3 GB of activations
# a layer (the fp32 token-shift mixes and decays, the group norm, the
# 7168-wide channel mix), over 80 GB at 24 layers: remat on.  zamba2-7b
# at phase 4's 15 layers (both tied blocks run; ~1.8 B parameters),
# qwen3-moe-235b-a22b at 1 layer (every layer is MoE: 4.83 GB of experts
# a layer; ~3.1 B parameters with the tables are ~37 GB of state, and a
# second layer's 2.4 B would not fit beside it), both at 4 x 1024
FAMILY_TRAINS = (("rwkv6-1.6b", None, TRAIN_S, TRAIN_STEPS, True, 2, True),
                 ("zamba2-7b", 15, 1024, 6, False, 2, False),
                 ("qwen3-moe-235b-a22b", 1, 1024, 6, False, 2, False))
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


def run_train_flash(dev, gen):
    """The forward flash launch at qwen2-0.5b's training shape (phase 9(a),
    ``TRAIN_B`` x ``TRAIN_S``, causal, bf16): held to its plain version
    with a planted fault caught (phase 3's rule), twice for the same
    bits, its o the same bits with and without lse and o_lo; the kernel's
    time as serving launches it (``ms``) and as training launches it,
    with lse and o_lo (``lo_ms``, the o_lo kernel), the plain version's,
    SDPA's and the bound."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.tolerance import check
    a = train_cfg().attention
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    q = rnd(TRAIN_B, TRAIN_S, a.num_heads, a.head_dim)
    k, v = (rnd(TRAIN_B, TRAIN_S, a.num_kv_heads, a.head_dim)
            for _ in range(2))
    scale = 1.0 / math.sqrt(a.head_dim)
    before = dict(fa.attention.paths)
    got = fa.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    path = launched_path(fa.attention.paths, before)
    if path != "tensor_core" or not torch.equal(got, fa.attention(q, k, v)):
        fail(f"train flash: path {path}, or two runs differ")
    if not torch.equal(got, fa._launch(q, k, v, True, 0, scale,
                                       with_lse=True)[0]):
        fail("train flash: o differs with and without lse and o_lo")
    want = fa.attention_plain(q, k, v, causal=True)
    ratio, diff = check(got, want, bf)
    fault, _ = check(fa.attention(q, k, v, scale=1.05 * scale), want, bf)
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
           "lo_ms": time_ms(lambda x, y, z: fa._launch(
               x, y, z, True, 0, scale, with_lse=True), [(q, k, v)],
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
          f"(scale x1.05 {fault:.1f})  kernel {row['ms']:.4f} ms (with lse "
          f"and o_lo {row['lo_ms']:.4f} ms)  plain "
          f"{row['plain_ms']:.4f} ms  library {row['library_ms']} ms "
          f"(SDPA {row['library_backend']})  bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    del q, k, v, mask
    release()
    return row


def phase_train_kernels(dev):
    """Phase 9(a): the backward's products at qwen2's training widths
    (T = 4 x 4096 rows; d 896, k/v 128, FFN 4864; the loss chunk's 2048
    rows against the 151,936-row table), the forward flash launch, and
    flash_attention's backward kernel (``run_flash_bwd``)."""
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
    rows.append(run_train_flash(dev, gen))
    gen.manual_seed(10)
    rows += run_flash_bwd(dev, gen)
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


def train_grads(dev, cfg, cpu_params, what, phase="9 train grads",
                lr=1e-2, yardstick=()):
    """One step's gradient of every leaf and GRAD_STEPS losses of ``cfg``
    (fp32, remat on, batch 4 x 128 Markov tokens, AdamW at peak ``lr``)
    from ``cpu_params``, card against CPU: each leaf's worst difference
    as a share of its largest |gradient| on the CPU, and the losses',
    under GRAD_TOL.  For each learning rate of ``yardstick``, the CPU's
    steps run twice more, plain and with every gradient perturbed by
    NOISE_REL of its leaf's largest magnitude (seeded normals): how far
    rounding-sized differences in the gradients move the losses at that
    rate, printed beside the card's difference."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_items, tree_map
    from repro_torch.optim import adamw
    opts = lm.RunOptions(chunk_q=32, chunk_kv=32, loss_chunk=32, remat=True)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         global_batch=4, seq_len=128))

    def run(d, rate, noise=0.0):
        tcfg = TrainConfig(learning_rate=rate, warmup_steps=2,
                           total_steps=GRAD_STEPS)
        params = tree_map(lambda t: t.to(d), cpu_params)
        batches = [{k: torch.from_numpy(v).to(d, torch.long)
                    for k, v in data.batch_at(i).items()}
                   for i in range(GRAD_STEPS)]
        _, grads = adamw.value_and_grad(
            lambda p, b: lm.train_loss(cfg, p, b, opts), params, batches[0])
        step = adamw.make_train_step(cfg, tcfg, opts)
        real = adamw.adamw_update
        if noise:
            gen = torch.Generator().manual_seed(5)
            adamw.adamw_update = lambda g, *a, **k: real(tree_map(
                lambda t: t + noise * t.abs().max() * torch.randn(
                    t.shape, generator=gen), g), *a, **k)
        opt, losses = adamw.adamw_init(params), []
        try:
            for b in batches:
                params, opt, m = step(params, opt, b)
                losses.append(float(m["loss"]))
        finally:
            adamw.adamw_update = real
        return {k: g.cpu() for k, g in tree_items(grads)}, losses

    def loss_rel(got, want):
        return max(abs(a - b) / b for a, b in zip(got, want))

    cpu = run(torch.device("cpu"), lr)
    card = run(dev, lr)
    worst = max((rel_err(g, cpu[0][k])[0], k) for k, g in card[0].items())
    loss_err = loss_rel(card[1], cpu[1])
    spread = {}
    for rate in yardstick:
        plain = cpu[1] if rate == lr else run(torch.device("cpu"), rate)[1]
        spread[rate] = loss_rel(run(torch.device("cpu"), rate,
                                    NOISE_REL)[1], plain)
    print(f"phase {phase}: {what} card vs CPU: worst leaf gradient "
          f"{worst[0]:.2e} of its largest magnitude ({worst[1]}; "
          f"{len(cpu[0])} leaves; tol {GRAD_TOL:.0e}); {GRAD_STEPS} "
          f"losses at lr {lr:g} {[round(x, 6) for x in card[1]]}, worst "
          f"rel err {loss_err:.2e} (tol {GRAD_TOL:.0e})"
          + "".join(f"; at lr {rate:g} the CPU's losses with gradients "
                    f"perturbed by {NOISE_REL:g} of each leaf's largest "
                    f"magnitude move by {v:.2e}"
                    for rate, v in spread.items()), flush=True)
    if not worst[0] < GRAD_TOL or not loss_err < GRAD_TOL:
        fail(f"{what}: card and CPU gradients or losses disagree")
    return {"worst_grad_rel": worst[0], "worst_leaf": worst[1],
            "loss_rel": loss_err, "losses": card[1], "lr": lr,
            "perturbed_loss_rel": spread}


def phase_train_grads(dev):
    """Phase 9(b): reduced fp32 qwen2 (2 layers, remat on), one step's
    gradient of every leaf and 5 steps of loss, card against CPU."""
    import dataclasses

    from repro_torch.configs import reduce_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduce_config(
        train_cfg(), layers=2, d_model=128, vocab=512), dtype="float32")
    cpu_params = lm.init_params(cfg, seed=0, device="cpu")
    _fan_in_qk(cpu_params, cfg)
    before = path_counts()["flash_attention_bwd"]["fma"]
    out = train_grads(dev, cfg, cpu_params, "reduced qwen2-0.5b fp32 "
                      "(2 layers, remat, batch 4 x 128)")
    if path_counts()["flash_attention_bwd"]["fma"] == before:
        fail("reduced qwen2 fp32: flash_attention's fma backward never "
             "launched")
    return out


def phase_family_grads(dev):
    """Phase 9(e): phase 4's reduced fp32 rwkv6-1.6b (2 layers: wkv6's
    forward and backward kernels, fp32), zamba2-7b (15: both tied
    blocks) and qwen3-moe-235b-a22b (2), as 9(b), the losses at
    FAMILY_GRAD_LR beside the CPU's own spread under perturbed
    gradients."""
    out = {}
    for arch in FAMILY_GRADS:
        cfg, cpu_params = reduced_model(arch)
        before = path_counts()["wkv6_bwd"]
        before_fa = path_counts()["flash_attention_bwd"]["fma"]
        out[arch] = train_grads(
            dev, cfg, cpu_params, f"reduced {arch} fp32 ({MODELS[arch]} "
            f"layers, remat, batch 4 x 128)", phase="9(e) train grads",
            lr=FAMILY_GRAD_LR, yardstick=(FAMILY_GRAD_LR, 1e-2))
        if cfg.rwkv is not None and path_counts()["wkv6_bwd"] == before:
            fail(f"{arch}: wkv6's backward kernel never launched")
        if attention_applications(cfg) and \
                path_counts()["flash_attention_bwd"]["fma"] == before_fa:
            fail(f"{arch}: flash_attention's fma backward never launched")
        release()
    return out


# a training step's kernels by family: flash_attention's backward
# kernels apart from its forward, and what cuBLAS runs (nothing on
# qwen2's path: every product is an spm_matmul launch)
TRAIN_FAMILIES = (
    TRACE_FAMILIES[:1]
    + (("flash_attention backward", ("flash_bwd",)),)
    + TRACE_FAMILIES[1:3]
    + (("cuBLAS products", TRACE_FAMILIES[3][1]),)
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
    want_bwd = {"tensor_core": cfg.num_layers, "fma": 0}
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
          f"{want_flash}; its backward {want_bwd}); over the run "
          f"{paths['spm_matmul']}, {paths['flash_attention']} and "
          f"{paths['flash_attention_bwd']}", flush=True)
    if not all(map(math.isfinite, loss)):
        fail(f"non-finite losses: {loss}")
    for i, st in enumerate(per_step):
        if st["spm_matmul"] != want or st["flash_attention"] != want_flash \
                or st["flash_attention_bwd"] != want_bwd:
            fail(f"train step {i + 1} launched {st}, reckoned spm_matmul "
                 f"{want}, flash_attention {want_flash} and its backward "
                 f"{want_bwd}")
    if paths["wkv6"]["tensor_core"] or paths["wkv6"]["fma"]:
        fail("wkv6 launched in qwen2's training")
    launches = {"spm_matmul": sum(paths["spm_matmul"].values()),
                "flash_attention": sum(paths["flash_attention"].values()),
                "flash_attention_bwd":
                    sum(paths["flash_attention_bwd"].values()),
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


# a training step's kernels by family, wkv6's backward apart from its
# forward
FAMILY_TRAIN_FAMILIES = (TRAIN_FAMILIES[:3]
                         + (("wkv6 backward", ("wkv6_bwd",)),)
                         + TRAIN_FAMILIES[3:])


def attention_applications(cfg):
    """The prefill-form attentions of one forward: a hybrid's shared
    block once a unit, none in RWKV, else one a layer."""
    if cfg.attention is None:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.ssm.shared_attn_every
    return cfg.num_layers


def phase_train_family(dev, arch, layers, seq, steps, remat, warmup,
                       hold_last, part):
    """Phase 9(f), (g): ``arch`` at full width (``layers`` cut with
    ``dataclasses.replace``) through ``train.train``, counters zeroed
    just before and read just after: the last loss must be below the
    first; every step must launch spm_matmul by path, flash_attention
    and wkv6's forward and backward as reckoned from the code (the
    forward launches twice a layer under remat: once in the step, once
    in the recompute); the step's numbers printed; one more step traced
    by kernel family.  The first step's batch's loss under the trained
    parameters must be below the first loss, and with ``hold_last`` so
    must the last step's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import lm
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    release()
    reset_launches()
    res = train.train(cfg, batch=TRAIN_B, seq=seq, steps=steps, remat=remat,
                      device=dev, warmup_steps=warmup, donate=True)
    paths = path_counts()
    fwd = 2 if remat else 1
    want = train_paths(train_products(cfg, TRAIN_B, seq, train.LOSS_CHUNK,
                                      remat))
    wkv_layers = cfg.num_layers if cfg.rwkv is not None else 0
    want_flash = fwd * attention_applications(cfg)
    want_flash_bwd = {"tensor_core": attention_applications(cfg), "fma": 0}
    want_wkv = {"tensor_core": fwd * wkv_layers, "fma": 0}
    want_bwd = {"tensor_core": wkv_layers, "fma": 0}
    loss, js = res["loss"], res["jitter"]
    print(f"phase 9{part} train: {arch} at full width, {cfg.num_layers} "
          f"layers, bf16, batch {TRAIN_B} x {seq}, {steps} steps, remat "
          f"{remat}: loss {loss[0]:.4f} -> {loss[-1]:.4f} (gradient norm "
          f"{res['grad_norm'][0]:.4g} -> {res['grad_norm'][-1]:.4g}); step "
          f"median {js['median'] * 1e3:.2f} ms, p99 {res['p99_s'] * 1e3:.2f}"
          f" ms, CoV {js['cov']:.4f} over steps 3-{steps}; "
          f"{res['tokens_per_s']:,.0f} tokens/s; model FLOPs a step "
          f"{res['model_flops']:.4g} ({res['peak_flop_share']:.4f} of 989 "
          f"TFLOP/s), the reference's {res['reference_model_flops']:.4g} "
          f"({res['reference_peak_flop_share']:.4f}); peak memory "
          f"{res['peak_memory'] / 2**30:.2f} GiB; deadline "
          f"{res['deadline']['deadline_s'] * 1e3:.1f} ms, overruns "
          f"{res['deadline']['overruns']}", flush=True)
    print(f"phase 9{part} train: launches per step {res['launches_per_step'][-1]}"
          f" (reckoned: spm_matmul {want}, flash_attention {want_flash}, "
          f"its backward {want_flash_bwd}, wkv6 {want_wkv}, wkv6 backward "
          f"{want_bwd}; the run's backward launches by path: attention "
          f"{paths['flash_attention_bwd']}, wkv6 {paths['wkv6_bwd']})",
          flush=True)
    if not all(map(math.isfinite, loss)):
        fail(f"{arch}: non-finite losses: {loss}")
    for i, st in enumerate(res["launches_per_step"]):
        if (st["spm_matmul"] != want or st["flash_attention"] != want_flash
                or st["flash_attention_bwd"] != want_flash_bwd
                or st["wkv6"] != want_wkv or st["wkv6_bwd"] != want_bwd):
            fail(f"{arch} train step {i + 1} launched {st}")
    launches = {"spm_matmul": sum(paths["spm_matmul"].values()),
                "flash_attention": sum(paths["flash_attention"].values()),
                "flash_attention_bwd":
                    sum(paths["flash_attention_bwd"].values()),
                "wkv6": sum(paths["wkv6"].values()),
                "wkv6_bwd": sum(paths["wkv6_bwd"].values())}
    # the last loss must be below the first, and so must the first
    # step's batch's under the trained parameters, as in 9(c)
    tr, state = res["trainer"], res["final_state"]
    batch0 = tr.batch_at(0)
    with torch.no_grad():
        again = float(lm.train_loss(cfg, state.params, batch0, tr.opts))
    print(f"phase 9{part} train: {arch}: the first step's batch after "
          f"training: loss {again:.4f} (first {loss[0]:.4f}, last "
          f"{loss[-1]:.4f})", flush=True)
    if not (again < loss[0] and (loss[-1] < loss[0] or not hold_last)):
        fail(f"{arch}: the loss did not fall: first {loss[0]}, last "
             f"{loss[-1]}, the first batch after training {again}")
    trace = trace_replays(
        f"train step ({arch}, {cfg.num_layers} layers, batch {TRAIN_B} x "
        f"{seq})", lambda i: tr._step_fn(state.params, state.opt_state,
                                         batch0), 1, phase=f"9{part}",
        families=FAMILY_TRAIN_FAMILIES)
    out = {k: v for k, v in res.items()
           if k not in ("final_state", "trainer")}
    out.update({"layers": cfg.num_layers, "seq": seq, "remat": remat,
                "trace": trace, "launches": launches})
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


def start_dryruns(runs, out_name):
    """Start each dry-run or roofline command of ``runs`` in a process
    of its own on the host's CPU, all at once (the process group is
    global to a process, and this one holds the card); their output
    goes to a log beside their records.  Returns what
    ``finish_dryruns`` waits for."""
    import shutil
    out = OUT_DIR / out_name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    started = []
    for i, (module, arch, shape, extra) in enumerate(runs):
        sub = out / module.rsplit(".", 1)[1]
        cmd = [sys.executable, "-m", module, "--arch", arch, "--shape",
               shape, "--out", str(sub)] + extra
        log = out / f"{i}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=fh,
                                    stderr=subprocess.STDOUT)
        started.append((module, arch, shape, sub, cmd, log, proc,
                        time.time()))
    return started


def phase_dryrun(runs=DRYRUNS, phase=10, out_name="dryrun"):
    """Phase 10: the dry run and the roofline (``start_dryruns``);
    every record must say ok."""
    return finish_dryruns(start_dryruns(runs, out_name), phase)


def finish_dryruns(started, phase):
    """Wait for ``start_dryruns``'s processes (each within
    DRYRUN_TIMEOUT_S of the first's start) and read their records:
    every one must say ok.  Any process still running when a check
    fails is killed."""
    try:
        return _read_dryruns(started, phase)
    finally:
        stop_dryruns(started)


def stop_dryruns(started):
    for *_, proc, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _read_dryruns(started, phase):
    from repro_torch.analysis.roofline import roofline_terms
    records = {}
    for module, arch, shape, sub, cmd, log, proc, t0 in started:
        try:
            code = proc.wait(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (time.time() - started[0][-1])))
        except subprocess.TimeoutExpired:
            fail(f"{' '.join(cmd[2:])} outlived {DRYRUN_TIMEOUT_S} s")
        print(f"phase {phase} dryrun: python -m {' '.join(cmd[2:])}: exit "
              f"{code} within {time.time() - t0:.1f} s", flush=True)
        files = sorted(sub.glob(f"*{arch}__{shape}*.json"))
        if code != 0 or not files:
            print(log.read_text()[-6000:], flush=True)
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
                colls = {k: f"{v['count']} ops, {v['bytes']:.4g} B"
                         for k, v in rec["collectives"].items()}
                terms = roofline_terms(flops, rec["bytes_accessed"],
                                       rec["collective_bytes"])
                rec["terms_h100"] = terms
                what = (f"{rec['n_devices']} devices; memory term from the "
                        f"unfused traced bytes {rec['bytes_accessed']:.4g}; "
                        f"{rec['view_gathers']} view gathers")
            print(f"phase {phase} dryrun {key}: status {rec['status']} "
                  f"({rec['total_s']} s); per-device FLOPs {flops:.4g}; "
                  f"collective bytes {colls}; {what}; H100 roofline: "
                  f"compute {terms['compute_s']:.4g} s, memory "
                  f"{terms['memory_s']:.4g} s, collective "
                  f"{terms['collective_s']:.4g} s, {terms['dominant']}-"
                  f"bound", flush=True)
        if code != 0:
            fail(f"{' '.join(cmd[2:])} exited {code}")
    return records


# ------------------------------------------------------- multidevice

# phase 11(a): full width at reduced depth (bf16, batch 4, prompt 256, 32
# new tokens), the depth cut with ``dataclasses.replace(cfg,
# num_layers=...)`` because the whole models (135-800 GB) do not fit in
# 80 GB: qwen3-moe-235b-a22b's 4 layers hold 4 x 4.83 GB of experts,
# llama4-maverick-400b-a17b's 2 (moe_every=2: one MoE and one dense
# layer) 32.2 GB of experts and its two 202,048 x 5120 tables,
# deepseek-67b's and qwen2-72b's 4 layers 1.38 and 1.76 GB a layer.
# Per key as in SERVES; "traces": the graphs phase 11 traces.
WIDE_SERVES = {
    # q, k, v and o a layer (the routed experts are einsums), the logits
    "qwen3-moe-235b-a22b@4L": {
        "arch": "qwen3-moe-235b-a22b", "layers": 4, "prompt": 256,
        "vocab": 151_936, "kernels": ("spm_matmul", "flash_attention"),
        "per_prefill": {"spm_matmul": 4 * 4 + 1, "flash_attention": 4},
        "mm_per_step": 4 * 4 + 1, "phase": 11, "traces": ("decode",)},
    # the MoE layer's attention and shared expert, the dense layer's
    # attention and FFN: 7 products each
    "llama4-maverick-400b-a17b@2L": {
        "arch": "llama4-maverick-400b-a17b", "layers": 2, "prompt": 256,
        "vocab": 202_048, "kernels": ("spm_matmul", "flash_attention"),
        "per_prefill": {"spm_matmul": 7 * 2 + 1, "flash_attention": 2},
        "mm_per_step": 7 * 2 + 1, "phase": 11, "traces": ("prefill",)},
    "deepseek-67b@4L": {
        "arch": "deepseek-67b", "layers": 4, "prompt": 256,
        "vocab": 102_400, "kernels": ("spm_matmul", "flash_attention"),
        "per_prefill": {"spm_matmul": 7 * 4 + 1, "flash_attention": 4},
        "mm_per_step": 7 * 4 + 1, "phase": 11, "traces": ()},
    "qwen2-72b@4L": {
        "arch": "qwen2-72b", "layers": 4, "prompt": 256,
        "vocab": 152_064, "kernels": ("spm_matmul", "flash_attention"),
        "per_prefill": {"spm_matmul": 7 * 4 + 1, "flash_attention": 4},
        "mm_per_step": 7 * 4 + 1, "phase": 11, "traces": ()},
}
EXPERT_FAMILY = "expert products (cuBLAS batched, gecd,edf)"
PROBE_CALLS = 10
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "nvjet")
# phase 11(b): one qwen3-moe MoE layer, bf16, tokens 4 x 256
EP_TOKENS = (4, 256)
# phase 11(d): the moe_ep variant's dry runs (each its own process)
EP_DRYRUNS = [
    ("repro_torch.launch.dryrun", "qwen3-moe-235b-a22b", "train_4k",
     ["--variant", "moe_ep", "--multi-pod", "both"]),
    ("repro_torch.launch.dryrun", "llama4-maverick-400b-a17b",
     "decode_32k", ["--variant", "moe_ep", "--multi-pod", "both"]),
]
MULTIDEVICE_TIMEOUT_S = 600


def _moe_leaves(params):
    """The first MoE layer's expert weights (its unit's slice of the
    stacked leaves) and the number of MoE layers."""
    from repro_torch.models.spec import tree_items
    found = [(path, t) for path, t in tree_items(params)
             if path.endswith("moe/we_gate")]
    prefix = found[0][0][:-len("we_gate")]
    p = {path[len(prefix):]: t[0] for path, t in tree_items(params)
         if path.startswith(prefix) and path[len(prefix):].startswith("we_")}
    return p, sum(t.shape[0] for _, t in found)


def expert_probe(kind):
    """A ``phase_capture`` probe: the kernels cuBLAS launches for the
    MoE layer's expert products (``ffn._expert_ffn``: the einsums
    ``gecd,edf->gecf`` and back) at the served ``kind``'s shapes, read
    off one eager call under the profiler, become a trace family of
    their own ahead of TRACE_FAMILIES; the same call's time by CUDA
    events is the expert products' ms for one layer."""
    def probe(cfg, params):
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import ffn
        p, n_moe = _moe_leaves(params)
        m = cfg.moe
        tokens = 4 if kind == "decode" else 4 * 256
        gs = min(m.group_size, tokens)
        while tokens % gs:
            gs -= 1
        shape = (tokens // gs, m.num_experts, m.capacity(gs), cfg.d_model)
        xe = torch.randn(shape, device=p["we_gate"].device).to(
            p["we_gate"].dtype)
        ffn._expert_ffn(p, xe, cfg.activation)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROBE_CALLS):
                ffn._expert_ffn(p, xe, cfg.activation)
            torch.cuda.synchronize()
        seen = [e.name for e in sorted(
            prof.events(), key=lambda e: e.time_range.start)
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(g in e.name for g in GEMM_NAMES)]
        # a call's products: gate (and up) and down.  A profiler session
        # that follows others in the process can miss the kernels of its
        # first milliseconds, so one call's kernels are the last call's
        products = 3 if "we_up" in p else 2
        names = seen[-products:]
        if len(names) < products:
            fail(f"the profiler saw {len(seen)} cuBLAS launches over "
                 f"{PROBE_CALLS} calls of {cfg.name}'s expert products, "
                 f"fewer than one call's {products}")
        ms = time_ms(lambda x: ffn._expert_ffn(p, x, cfg.activation),
                     [(xe,)])
        print(f"phase 11 probe {cfg.name} {kind}: the expert products on "
              f"[G, E, C, d] = {list(shape)} launch {len(names)} cuBLAS "
              f"kernels ({sorted(set(names))}); one layer's "
              f"_expert_ffn {ms:.4f} ms (CUDA events); {n_moe} MoE layers",
              flush=True)
        families = ((EXPERT_FAMILY, tuple(set(seen))),) + TRACE_FAMILIES
        return families, {"shape": list(shape), "kernels": names,
                          "moe_layers": n_moe, "layer_ms": ms}
    return probe


def multidevice_rank(out_path):
    """Phase 11(b) and (c), in a process of their own as rank 0 of a
    one-rank NCCL group (a ``fake`` group moves no data): (b)
    ``moe_ffn_ep`` on one qwen3-moe MoE layer at full width on a 1x1
    CUDA mesh, held element by element to ``moe_ffn(impl="gather")``
    with ``group_size`` the shard's N (EP dispatches a shard's tokens as
    one group), and the same check made to catch one expert's output
    slots shifted by one; (c) a checkpoint of reduced qwen2-0.5b written
    by ``CheckpointManager.save`` (the trainer's, phase 9(d)'s code)
    restored with ``shardings=`` onto the mesh: every leaf a DTensor on
    cuda, bit-identical; and ``compressed_grad_mean`` at pod size 1
    returning its input.  Writes its numbers to ``out_path``."""
    import dataclasses
    import shutil

    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels.tolerance import check
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import rules_for
    from repro_torch.models import ffn, lm
    from repro_torch.models.spec import init_tree, shape_tree, tree_items
    from repro_torch.models.spec import tree_map
    from repro_torch.optim.compression import compressed_grad_mean
    import torch.distributed as dist

    out = Path(out_path)
    init_world("nccl", 0, 1, str(out.parent / "multidevice_store"))
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    dev = torch.device(mesh.device_type)        # the rank's own card
    rec = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend()}

    # (b) EP against gather on the same grouping
    cfg = get_config("qwen3-moe-235b-a22b")
    B, S = EP_TOKENS
    m = cfg.moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    p = init_tree(ffn.moe_spec(cfg.d_model, m, cfg.activation, "bfloat16"),
                  gen, dev)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    with implicit_replication():
        y_ep, _ = ffn.moe_ffn(p, xd, m, cfg.activation, "ep", ("data",))
    y_ep = y_ep.to_local()
    same_group = dataclasses.replace(m, group_size=B * S)
    want, _ = ffn.moe_ffn(p, x, same_group, cfg.activation, "gather")
    ratio, diff = check(y_ep, want, torch.bfloat16)
    # the planted fault: the busiest expert's output slots shifted by one
    gates = torch.softmax(x.reshape(-1, cfg.d_model).float() @ p["router"],
                          -1)
    busiest = int(torch.bincount(torch.topk(gates, m.top_k).indices
                                 .reshape(-1), minlength=m.num_experts)
                  .argmax())
    combine = ffn._gather_combine

    def shifted(ye, *a):
        ye = ye.clone()
        ye[:, busiest] = torch.roll(ye[:, busiest], 1, dims=1)
        return combine(ye, *a)

    ffn._gather_combine = shifted
    try:
        with implicit_replication():
            y_bad, _ = ffn.moe_ffn(p, xd, m, cfg.activation, "ep",
                                   ("data",))
    finally:
        ffn._gather_combine = combine
    fault, _ = check(y_bad.to_local(), want, torch.bfloat16)
    rec["ep"] = {"tokens": [B, S], "capacity": m.capacity(B * S),
                 "err_ratio": ratio, "max_abs_err": diff,
                 "bit_identical": bool(torch.equal(y_ep, want)),
                 "fault_ratio": fault, "busiest_expert": busiest,
                 "finite": bool(torch.isfinite(y_ep).all())}
    del p, x, xd, y_ep, y_bad, want
    torch.cuda.empty_cache()

    # (c) the re-mesh restore onto the one-rank CUDA mesh
    small = reduce_config(train_cfg(), layers=2, d_model=128, vocab=512)
    params = lm.init_params(small, seed=0, device=dev)
    ckpt = out.parent / "multidevice_ckpt"
    if ckpt.exists():
        shutil.rmtree(ckpt)
    CheckpointManager(str(ckpt)).save(3, {"params": params})
    rules = rules_for(mesh, small, SHAPES["train_4k"])
    sh = {"params": tree_map(lambda t: (mesh, t.placements),
                             shape_tree(lm.model_spec(small), rules))}
    restored, step = CheckpointManager(str(ckpt)).restore(
        {"params": params}, shardings=sh)
    leaves = list(tree_items(restored["params"]))
    bits = all(torch.equal(t.full_tensor().reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8))
               for (_, t), (_, want) in zip(leaves, tree_items(params)))
    rec["restore"] = {
        "step": step, "leaves": len(leaves),
        "dtensor_on_cuda": all(isinstance(t, DTensor)
                               and t.to_local().device.type == "cuda"
                               for _, t in leaves),
        "bit_identical": bits}
    pod_mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    rec["compressed_mean_pod1_is_input"] = \
        compressed_grad_mean(params, pod_mesh) is params
    out.write_text(json.dumps(rec, indent=1))
    dist.destroy_process_group()


def phase_multidevice(dev):
    """Phase 11 on the card: (a) the four full-width serves at reduced
    depth, each with its launches, paths, tokens, decode and prefill
    times and peak memory, qwen3-moe's decode graph and llama4's
    prefill graph traced with the expert products as a family; (b) and
    (c) in a subprocess (``multidevice_rank``).  (d), the moe_ep
    variant's dry runs (EP_DRYRUNS), runs on the host's CPU after it.
    Returns the phase's record, the serves' wrapper launches and what
    their timed graph replays launched."""
    serves, captures = {}, {}
    for key, want in WIDE_SERVES.items():
        serves[key] = phase_serve(key)
        release()
        if want["traces"]:
            kind = want["traces"][0]
            captures[key] = phase_capture(dev, key, phase=11,
                                          traces=want["traces"],
                                          probe=expert_probe(kind))
            tr = captures[key][f"{kind}_trace"]
            probed = captures[key]["probe"]
            want_n = len(probed["kernels"]) * probed["moe_layers"]
            got_n = round(tr["families_launches"][EXPERT_FAMILY], 6)
            print(f"phase 11 trace {key} {kind}: expert products "
                  f"{tr['families_ms'][EXPERT_FAMILY]:.4f} ms of "
                  f"{tr['replay_ms']:.4f} a replay, {got_n:g} launches "
                  f"(the probe's {len(probed['kernels'])} x "
                  f"{probed['moe_layers']} MoE layers = {want_n}: "
                  f"{'exact' if got_n == want_n else 'the names are shared with other kernels; an upper bound'})",
                  flush=True)
            captures[key]["expert_family_exact"] = got_n == want_n
            release()

    out = OUT_DIR / "multidevice_rank.json"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-c",
           f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
           f"import chip_smoke; chip_smoke.multidevice_rank({str(out)!r})"]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=MULTIDEVICE_TIMEOUT_S,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print(f"phase 11 multidevice rank (one-rank NCCL group): exit "
          f"{r.returncode} in {time.time() - t0:.1f} s", flush=True)
    if r.returncode != 0 or not out.exists():
        print(r.stdout[-3000:], r.stderr[-5000:], flush=True)
        fail("the one-rank multidevice process failed")
    rank = json.loads(out.read_text())
    ep, rs = rank["ep"], rank["restore"]
    print(f"phase 11 ep: moe_ffn_ep on a 1x1 {rank['backend']} mesh "
          f"(world size {rank['world_size']}), qwen3-moe layer bf16 "
          f"tokens {ep['tokens']} (C {ep['capacity']}) against "
          f"moe_ffn(gather) with group_size {ep['tokens'][0] * ep['tokens'][1]}: "
          f"error {ep['err_ratio']:.4f} of its allowance (max abs "
          f"{ep['max_abs_err']:.3e}, bit-identical {ep['bit_identical']}); "
          f"expert {ep['busiest_expert']}'s slots shifted by one "
          f"{ep['fault_ratio']:.2f}", flush=True)
    if not (ep["finite"] and ep["err_ratio"] < 1):
        fail("moe_ffn_ep disagrees with the gather dispatch on the card")
    if not ep["fault_ratio"] > 1:
        fail("the EP check misses a shifted expert slot")
    print(f"phase 11 restore: {rs['leaves']} leaves of reduced qwen2-0.5b "
          f"(step {rs['step']}) restored with shardings= onto the 1x1 "
          f"cuda mesh: DTensors on cuda {rs['dtensor_on_cuda']}, "
          f"bit-identical {rs['bit_identical']}; compressed_grad_mean at "
          f"pod size 1 returns its input "
          f"{rank['compressed_mean_pod1_is_input']}", flush=True)
    if not (rs["dtensor_on_cuda"] and rs["bit_identical"]
            and rank["compressed_mean_pod1_is_input"]):
        fail("the sharded restore or the compressed mean at pod 1 failed")

    launches = {k: sum(l[k] for l, _ in serves.values())
                for k in next(iter(serves.values()))[0]}
    record = {
        "serve": {key: {"prefill_ms": res["prefill_s"] * 1e3,
                        "decode_ms": [t * 1e3 for t in res["decode_s"]],
                        "jitter": res["jitter"], "wcet_ms": res["wcet_s"] * 1e3,
                        "peak_gib": res["peak_gib"], "plan": res["plan"],
                        "launches": l, "paths": res["paths"],
                        "prefill_launches": res["prefill_launches"],
                        "replayed_launches": res["replayed_launches"],
                        "flop_shares": res["flop_shares"],
                        **captures.get(key, {})}
                  for key, (l, res) in serves.items()},
        "rank": rank}
    replayed = {k: sum(r["replayed_launches"][k] + r["prefill_launches"][k]
                       for _, r in serves.values()) for k in launches}
    return record, launches, replayed


def path_counts():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.spm_matmul import ops as mm_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    return {"spm_matmul": dict(mm_ops.matmul.paths),
            "flash_attention": dict(fa_ops.attention.paths),
            "flash_attention_bwd": dict(fa_ops.attention.bwd_paths),
            "wkv6": dict(wkv_ops.wkv.paths),
            "wkv6_bwd": dict(wkv_ops.wkv.bwd_paths)}


def reset_launches():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.spm_matmul import ops as mm_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    mm_ops.matmul.launches = 0
    fa_ops.attention.launches = 0
    fa_ops.attention.bwd_launches = 0
    wkv_ops.wkv.launches = 0
    wkv_ops.wkv.bwd_launches = 0
    for counts in (mm_ops.matmul.paths, fa_ops.attention.paths,
                   fa_ops.attention.bwd_paths, wkv_ops.wkv.paths,
                   wkv_ops.wkv.bwd_paths):
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
        "wkv6": "src/repro/kernels/wkv6/wkv6.py:84",
        # the gradients of those kernels' functions, which the reference
        # takes by jax.grad of its jnp forms
        "flash_attention_bwd":
            "src/repro/kernels/flash_attention/flash_attention.py:75",
        "wkv6_bwd": "src/repro/kernels/wkv6/wkv6.py:84"}
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
            "launches": launches.get(name, 0) + trained.get(name, 0),
            "train_launches": trained.get(name, 0),
            "replayed_launches": replayed.get(name, 0),
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
    families = phase_family_grads(dev)
    wide = {}
    for spec, part in zip(FAMILY_TRAINS, "fgg"):
        wide[spec[0]], moved = phase_train_family(dev, *spec, part)
        for k, n in moved.items():
            launches[k] = launches.get(k, 0) + n
    return rows, {"grads": grads, "run": run, "launches": launches,
                  "resume": resume, "family_grads": families,
                  "family_runs": wide, "cases": rows}


def seeded(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def subset_flash_forward(dev):
    """The forward's cases alone: phase 3's ``flash_cases`` and phase
    9(a)'s train forward (with and without lse and o_lo)."""
    rows = run_flash(dev, seeded(dev, 0))
    rows.append(run_train_flash(dev, seeded(dev, 9)))
    return rows


def subset_zamba2_instruct(dev):
    """zamba2-7b-instruct alone: phase 3's spm_matmul and flash cases of
    its shapes, then phase 5's serve of it and its capture (with phase
    6's traces)."""
    arch = "zamba2-7b-instruct"
    rows = run_matmul(dev, seeded(dev, 0), arch)
    rows += run_flash(dev, seeded(dev, 0), arch)
    launches, res = phase_serve(arch)
    release()
    capture = phase_capture(dev, arch)
    release()
    return {"cases": rows, "launches": launches,
            "serve": {k: res[k] for k in (
                "prefill_s", "decode_s", "jitter", "plan", "paths",
                "prefill_launches", "replayed_launches", "peak_gib")},
            "capture": capture}


def subset_multidevice(dev):
    multi, _, _ = phase_multidevice(dev)
    multi["dryrun"] = phase_dryrun(EP_DRYRUNS, 11, "dryrun_moe_ep")
    return multi


# ``python3 chip_smoke.py <name>``: phase 1, phase 2 where ``build`` (and
# then no plan cache, ``REPRO_AUTOTUNE=0``), then ``run(dev)``, whose
# record goes to ``chiprun_out/<file>``; no result lines.
#   name: (what it runs, build, run, file)
SUBSETS = {
    "mm": ("phase 3's spm_matmul cases", True,
           lambda dev: run_matmul(dev, seeded(dev, 0)),
           "chip_smoke_matmul.json"),
    "3": ("phase 3's wkv6 backward cases", True,
          lambda dev: run_wkv_bwd(dev, seeded(dev, 0)),
          "chip_smoke_wkv_bwd.json"),
    "fwd": ("the flash forward's cases (phase 3's and phase 9(a)'s train "
            "forward)", True, subset_flash_forward,
            "chip_smoke_flash_fwd.json"),
    "9a": ("phase 9(a)'s flash backward cases", True,
           lambda dev: run_flash_bwd(dev, seeded(dev, 10)),
           "chip_smoke_flash_bwd.json"),
    "9": ("the training phase", True,
          lambda dev: phase_train_phases(dev)[1], "chip_smoke_train.json"),
    "10": ("the dry run", False, lambda dev: phase_dryrun(),
           "chip_smoke_dryrun.json"),
    "11": ("the multi-device layer and the wide serves", True,
           subset_multidevice, "chip_smoke_multidevice.json"),
    "zamba2-7b-instruct": ("phase 3's cases at zamba2-7b-instruct's "
                           "shapes, phase 5's serve and capture of it",
                           True, subset_zamba2_instruct,
                           "chip_smoke_zamba2-7b-instruct.json")}


def main():
    if len(sys.argv) > 1:
        if sys.argv[1:] not in [[name] for name in SUBSETS]:
            fail(f"usage: chip_smoke.py [{'|'.join(SUBSETS)}]")
        _, build, run, name = SUBSETS[sys.argv[1]]
        if build:
            os.environ["REPRO_AUTOTUNE"] = "0"
        dev, _ = phase_device()
        if build:
            phase_build()
        record = run(dev)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / name).write_text(json.dumps(record, indent=1,
                                               default=str))
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
    # phase 11 launches what the code launches untuned, as phase 9 does
    multi, wide_launches, wide_replayed = phase_multidevice(dev)
    # the dry runs of phases 10 and 11 on the host's CPU, all at once,
    # after the card's timed work
    ten = start_dryruns(DRYRUNS, "dryrun")
    eleven = start_dryruns(EP_DRYRUNS, "dryrun_moe_ep")
    try:
        dry = finish_dryruns(ten, 10)
        multi["dryrun"] = finish_dryruns(eleven, 11)
    finally:
        stop_dryruns(eleven)
    (OUT_DIR / "chip_smoke_multidevice.json").write_text(json.dumps(
        multi, indent=1, default=str))
    launches = {k: n + wide_launches[k] for k, n in launches.items()}
    replayed = {k: n + wide_replayed[k] for k, n in replayed.items()}
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
