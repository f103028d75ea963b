"""spm_matmul's split-K decode path at the benchmark's decode products,
timed from several checkouts of this repository in turns on one card.

Each ``--trees`` entry is a checkout's root (this one, ``.``, or an
unpacked parent commit under a git-ignored directory); each run is a
subprocess that imports that tree's ``repro_torch`` and builds its
kernels into that tree's ``build/``.  The builds start together first;
then the runs go in the order given, so ``--trees build/parent . .
build/parent`` times parent, change, change, parent.  A run times, at
pixtral-12b's five decode products and rwkv6-1.6b's seven, each at the
benchmark's batch (16 and 8) and at 4:

- the wrapper (``ops.matmul``, which launches the split-K kernel at
  these shapes; the run fails if it launches another path) (``ms``),
  with the split it took (``splits``);
- ``torch.mm`` at the same shapes, the yardstick (``torch_mm_ms``);

each by CUDA events around a captured graph of calls that cycle through
copies of the weight which together exceed the 50 MB L2, so every call
finds its weight cold, as a decode step does (the median of three
replays, as ``chip_smoke.py``'s ``time_ms``).  ``bound_ms`` is the
datasheet bound, max(bytes / 3.35 TB/s, operations / 989 TFLOP/s), each
operand read once and C written once.

Prints one JSON line a run with the card's name and power limit, and
writes them all to ``chiprun_out/splitk_turns.json``.

  python3 scripts/splitk_turns.py --trees build/parent . . build/parent
"""
import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, K, N): the products of one decode step (portbench's layouts)
PIXTRAL = (("pixtral q proj", 5120, 4096), ("pixtral k/v proj", 5120, 1024),
           ("pixtral o proj", 4096, 5120), ("pixtral gate/up", 5120, 14336),
           ("pixtral down", 14336, 5120))
RWKV = (("rwkv r/k/v/g/o, cm r", 2048, 2048), ("rwkv cm k", 2048, 7168),
        ("rwkv cm v", 7168, 2048), ("rwkv mix_w1", 2048, 160),
        ("rwkv mix_w2", 32, 2048), ("rwkv wd_w1", 2048, 64),
        ("rwkv wd_w2", 64, 2048))
SHAPES = tuple((f"{label} M{m}", m, k, n)
               for group, ms in ((PIXTRAL, (16, 4)), (RWKV, (8, 4)))
               for m in ms for label, k, n in group)
L2_BYTES = 50 * 2 ** 20


def graph_ms(fn, arg_sets, reps=20):
    """Device ms a call: ``reps`` calls cycling through ``arg_sets``
    captured into one CUDA graph, replayed between CUDA events; the
    median of three replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    reps = max(reps, len(arg_sets))
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


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels.spm_matmul import ops
    out = {"tree": str(tree), "ms": {}, "splits": {}, "torch_mm_ms": {},
           "bound_ms": {}}
    gen = torch.Generator(device="cuda")
    for label, m, k, n in SHAPES:
        gen.manual_seed(m * k + n)
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(k, n, generator=gen, device="cuda")
             / math.sqrt(k)).bfloat16()
        before = ops.matmul.paths["splitk"]
        ops.matmul(a, b)
        torch.cuda.synchronize()
        if ops.matmul.paths["splitk"] != before + 1:
            raise RuntimeError(f"{label}: not on the split-K path")
        copies = max(1, min(512, math.ceil(2 * L2_BYTES / (k * n * 2))))
        sets = [(a, b)] + [(a, b.clone()) for _ in range(copies - 1)]
        out["ms"][label] = graph_ms(lambda x, y: ops.matmul(x, y), sets)
        out["splits"][label] = ops.dispatch(
            m, k, n, torch.bfloat16, False, True)["splits"]
        out["torch_mm_ms"][label] = graph_ms(torch.mm, sets)
        nbytes = (m * k + k * n + m * n) * 2
        out["bound_ms"][label] = max(nbytes / 3.35e12,
                                     2 * m * k * n / 989e12) * 1e3
        del sets, a, b
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve())), flush=True)
        return
    trees = [(ROOT / t).resolve() for t in args.trees]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import _build; "
         "_build.build(('spm_matmul',))"],
        cwd=tree) for tree in dict.fromkeys(trees)]
    for proc in builds:
        if proc.wait() != 0:
            sys.exit("a tree's kernels did not build")
    runs = []
    for tree in trees:
        res = subprocess.run(
            [sys.executable, __file__, "--child", str(tree)],
            capture_output=True, text=True, cwd=tree)
        if res.returncode != 0:
            sys.exit(f"{tree}: {res.stderr[-2000:]}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["card"] = smi
        runs.append(run)
        print(json.dumps(run), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "splitk_turns.json").write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
