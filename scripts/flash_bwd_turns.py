"""flash_attention's forward and backward at the main path's shapes,
timed from several checkouts of this repository in turns on one card.

Each ``--trees`` entry is a checkout's root (this one, ``.``, or an
unpacked parent commit under a git-ignored directory); each run is a
subprocess that imports that tree's ``repro_torch`` and builds its
kernels into that tree's ``build/``.  The builds start together first;
then the runs go in the order given, so ``--trees build/parent . .
build/parent`` times parent, change, change, parent.  A run times, by
CUDA events around a captured graph of ``--reps`` calls (the median of
three replays, as ``chip_smoke.py``'s ``time_ms`` does):

- the forward (``ops._launch``) at phase 3's main-path cases and at
  qwen2-0.5b's training shape, as serving launches it (``fwd_ms``) and
  with lse and o_lo as training launches it (``fwd_lo_ms``);
- the backward (``ops.attention_bwd``) at the three training shapes,
  fed that tree's forward's lse (and o and o_lo where its backward
  takes them) (``ms``).

Prints one JSON line a run with the card's name and power limit, and
writes them all to ``chiprun_out/flash_bwd_turns.json``.

  python3 scripts/flash_bwd_turns.py --trees build/parent . . build/parent
"""
import argparse
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, B, S, H, KV, D): causal bf16, as phase 9(a) of chip_smoke.py
SHAPES = (("qwen2-0.5b", 4, 4096, 14, 2, 64),
          ("zamba2-7b", 4, 1024, 32, 32, 112),
          ("qwen3-moe", 4, 1024, 64, 4, 128))
# (label, B, Sq, Sk, H, KV, D, causal, window): phase 3's main-path
# forward cases (bf16) and phase 9(a)'s train forward
FWD_SHAPES = (
    ("serve prefill", 4, 256, 256, 14, 2, 64, True, 0),
    ("gemma3 prefill, global", 4, 2048, 2048, 16, 8, 256, True, 0),
    ("gemma3 prefill, local", 4, 2048, 2048, 16, 8, 256, True, 1024),
    ("zamba2 shared-attention prefill", 4, 512, 512, 32, 32, 112, True, 0),
    ("whisper encoder and cross prefill", 4, 1536, 1536, 8, 8, 64, False,
     0),
    ("whisper decoder self prefill", 4, 1536, 1536, 8, 8, 64, True, 0),
    ("pixtral prefill", 4, 1024, 1024, 32, 8, 128, True, 0),
    ("qwen3-moe prefill (group 16)", 4, 256, 256, 64, 4, 128, True, 0),
    ("deepseek, qwen2-72b prefill", 4, 256, 256, 64, 8, 128, True, 0),
    ("llama4 prefill", 4, 256, 256, 40, 8, 128, True, 0),
    ("qwen2-0.5b train", 4, 4096, 4096, 14, 2, 64, True, 0))


def graph_ms(fn, reps):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
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
    return sorted(times)[1]


def time_forward(ops, out, reps, gen):
    """The forward at ``FWD_SHAPES`` into ``out['fwd_ms']`` (serving's
    launch) and ``out['fwd_lo_ms']`` (with lse and o_lo)."""
    import torch
    out["fwd_ms"], out["fwd_lo_ms"] = {}, {}
    for label, B, Sq, Sk, H, KV, D, causal, w in FWD_SHAPES:
        gen.manual_seed(Sq * D + H)
        q, k, v = (torch.randn(B, s, n, D, generator=gen, device="cuda")
                   .bfloat16() for s, n in ((Sq, H), (Sk, KV), (Sk, KV)))
        scale = 1.0 / math.sqrt(D)
        out["fwd_ms"][label] = graph_ms(lambda: ops._launch(
            q, k, v, causal, w, scale), reps)
        out["fwd_lo_ms"][label] = graph_ms(lambda: ops._launch(
            q, k, v, causal, w, scale, with_lse=True), reps)
        del q, k, v


def child(tree: Path, reps: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels.flash_attention import ops
    params = inspect.signature(ops.attention_bwd).parameters
    out = {"tree": str(tree), "ms": {}}
    gen = torch.Generator(device="cuda")
    time_forward(ops, out, reps, gen)
    torch.cuda.empty_cache()
    gen.manual_seed(10)
    for label, B, S, H, KV, D in SHAPES:
        q, k, v, do = (torch.randn(B, S, n, D, generator=gen, device="cuda")
                       .bfloat16() for n in (H, KV, KV, H))
        scale = 1.0 / math.sqrt(D)
        fwd = ops._launch(q, k, v, True, 0, scale, with_lse=True)
        extra = {}
        if "o_lo" in params:        # the forward's o and o_lo feed D_i
            extra = {"o": fwd[0], "o_lo": fwd[2]}
        lse = fwd[1]
        out["ms"][label] = graph_ms(lambda: ops.attention_bwd(
            q, k, v, lse, do, causal=True, window=0, scale=scale, **extra),
            reps)
        del q, k, v, do, fwd, extra, lse
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.reps)),
              flush=True)
        return
    trees = [(ROOT / t).resolve() for t in args.trees]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import _build; "
         "_build.build(('flash_attention', 'flash_attention_bwd'))"],
        cwd=tree) for tree in dict.fromkeys(trees)]
    for proc in builds:
        if proc.wait() != 0:
            sys.exit("a tree's kernels did not build")
    runs = []
    for tree in trees:
        res = subprocess.run(
            [sys.executable, __file__, "--child", str(tree), "--reps",
             str(args.reps)], capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            sys.exit(f"{tree}: {res.stderr[-2000:]}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["card"] = smi
        runs.append(run)
        print(json.dumps(run), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_bwd_turns.json").write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
