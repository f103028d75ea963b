"""Multi-pod dry run (the reference's ``launch/dryrun.py``): trace every
(architecture x input-shape) cell's step on the production meshes and
record its per-device cost and collectives, with no memory allocated.
The proof that the distribution config is coherent without the
hardware.

The step runs over ``meta`` DTensors on a ``fake`` process group of 256
or 512 ranks (``launch/mesh.py``), this process standing for rank 0;
``analysis.comm.TracedCost`` counts what rank 0 computes and moves.
The reference lowers and compiles with XLA; where a record field came
from XLA alone, the port's stand-in is:

  flops, bytes_accessed  the traced local ops (matrix products by their
                         registered FLOP formulas; bytes unfused);
                         the port has no scan, so every unit is traced
                         and these are whole-step totals, where XLA
                         counts a scanned body once
  collectives            c10d_functional ops by the reference's kinds,
                         bytes = output size
  memory                 argument_bytes / output_bytes: the summed
                         local-shard bytes of the step's arguments and
                         outputs (no temp or code sizes: nothing is
                         compiled)
  lower_s                the trace's seconds (there is no compile_s)

The train step is the healthy step of ``optim.adamw.make_train_step``:
gradients, clip, update; its non-finite guard reads the loss on the
host, which ``meta`` has no value for.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      [--multi-pod single|multi|both] [--out experiments/dryrun_torch]
  python -m repro_torch.launch.dryrun --all [--multi-pod both]
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

OUT_DEFAULT = "experiments/dryrun_torch"
# a sweep's limit for one cell's trace: the plain versions run on meta
# DTensors op by op, and wkv6's is a loop over every position, so an
# RWKV cell's full sequence takes far longer than its one-chunk pieces
CELL_TIMEOUT_S = 600
MESHES = {"single": ("single",), "multi": ("multi",),
          "both": ("single", "multi")}


def step_fn_for(cfg, shape, opts, variant: str = "baseline"):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import lm as lm_mod
    from repro_torch.optim.adamw import (adamw_update, cosine_lr,
                                         global_norm, loss_and_grads)
    if shape.kind == "train":
        tcfg = TrainConfig(microbatch=4 if "micro4" in variant else 0)
        lr_fn = cosine_lr(tcfg)
        loss_fn = lambda p, b: lm_mod.train_loss(cfg, p, b, opts)

        def train_step(params, opt_state, batch):
            loss, grads = loss_and_grads(loss_fn, params, batch,
                                         tcfg.microbatch)
            return adamw_update(grads, opt_state, params, tcfg, lr_fn,
                                global_norm(grads))
        return train_step

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return lm_mod.prefill(cfg, params, batch, opts)
        return prefill_step

    def serve_step(params, cache, token, pos):
        return lm_mod.decode_step(cfg, params, cache, token, pos, opts)
    return serve_step


def trace(fn, *args) -> dict:
    """``analysis.comm.traced_stats`` of ``fn(*args)``, with the plain
    tensors the model makes beside its DTensor inputs taken as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis.comm import traced_stats
    with implicit_replication():
        return traced_stats(fn, *args)


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, variant: str = "baseline") -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    from repro_torch.launch.specs import input_specs, run_options

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = 512 if multi_pod else 256
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
        "n_devices": n, "kind": shape.kind, "variant": variant,
        "status": "unknown",
    }
    t0 = time.time()
    try:
        init_fake_world(n)
        mesh = make_production_mesh(multi_pod=multi_pod)
        opts = run_options(cfg, shape, mesh, variant)
        step = step_fn_for(cfg, shape, opts, variant)
        specs = input_specs(cfg, shape, mesh, variant)
        rec.update(trace(step, *specs))
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = "" if variant == "baseline" else f"{variant}__"
    fname = f"{prefix}{arch}__{shape_name}__{rec['mesh']}.json"
    (out_dir / fname).write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: "
          f"{rec['status']} ({rec['total_s']}s)", flush=True)
    return rec


def all_cells(which_meshes=("single", "multi")):
    from repro_torch.configs import get_config, supported_shapes
    from repro_torch.configs.all_archs import ALL_ARCH_IDS
    for arch in ALL_ARCH_IDS:
        for shape_name in supported_shapes(get_config(arch)):
            for m in which_meshes:
                yield arch, shape_name, m == "multi"


def _cell_cmd(args, arch, shape_name, multi) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape_name, "--out", args.out,
           "--variant", args.variant, "--multi-pod",
           "multi" if multi else "single"]
    return cmd


def orchestrate(args, cells) -> int:
    """Run each cell in a subprocess of its own (one process group per
    process; one failure doesn't kill the sweep)."""
    out = pathlib.Path(args.out)
    prefix = "" if args.variant == "baseline" else f"{args.variant}__"
    failures = []
    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{mesh_name(mp)}"
        f = out / f"{prefix}{tag}.json"
        if f.exists() and not args.force:
            if json.loads(f.read_text()).get("status") == "ok":
                print(f"[skip] {tag} (cached ok)", flush=True)
                continue
        try:
            r = subprocess.run(_cell_cmd(args, arch, shape_name, mp),
                               env={**os.environ}, timeout=CELL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            # not reached: recorded, so a sweep's table can say so
            out.mkdir(parents=True, exist_ok=True)
            f.write_text(json.dumps({
                "arch": arch, "shape": shape_name, "mesh": mesh_name(mp),
                "variant": args.variant, "status": "timeout",
                "total_s": CELL_TIMEOUT_S}, indent=1))
            failures.append(tag + " (timeout)")
            continue
        if r.returncode != 0:
            failures.append(tag)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run sweep complete")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", nargs="?", const="multi",
                    default="single", choices=sorted(MESHES),
                    dest="multi_pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=OUT_DEFAULT)
    args = ap.parse_args()
    meshes = MESHES[args.multi_pod]
    if args.all:
        sys.exit(orchestrate(args, all_cells(meshes)))
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    if len(meshes) > 1:
        # one process group per process: each mesh in a subprocess
        sys.exit(orchestrate(args, [(args.arch, args.shape, m == "multi")
                                    for m in meshes]))
    rec = run_cell(args.arch, args.shape, args.multi_pod == "multi",
                   pathlib.Path(args.out), args.variant)
    sys.exit(0 if rec["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
