"""Roofline runner (the reference's ``launch/roofline_run.py``): trace
every cell's cost PIECES on the single-pod production mesh, compose
totals (piece x multiplier), add the analytic MODEL_FLOPS, and emit the
three roofline terms at the H100's rates (``analysis/roofline.py``).

Each piece runs over ``meta`` DTensors on a ``fake`` 256-rank process
group (``launch/mesh.py``) under ``analysis.comm.TracedCost``, as the
dry run's step does; a piece's record holds its per-device flops,
unfused bytes and collectives, and ``memory`` stands in for XLA's
memory analysis as in ``launch/dryrun.py``.

Usage:
  python -m repro_torch.launch.roofline_run --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.roofline_run --all
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

OUT_DEFAULT = "experiments/roofline_torch"
CHIPS = 256


def run_cell(arch: str, shape_name: str, out_dir: pathlib.Path,
             variant: str = "baseline", opt_overrides=None) -> dict:
    from repro_torch.analysis.bytes_model import analytic_bytes
    from repro_torch.analysis.flops import (active_param_count,
                                            model_flops, param_count)
    from repro_torch.analysis.pieces import cost_pieces
    from repro_torch.analysis.roofline import compose_pieces, roofline_terms
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import trace
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    from repro_torch.launch.specs import rules_for, run_options

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "16x16",
           "chips": CHIPS, "variant": variant, "status": "unknown",
           "pieces": []}
    t0 = time.time()
    try:
        init_fake_world(CHIPS)
        mesh = make_production_mesh(multi_pod=False)
        rules = rules_for(mesh, cfg, shape, variant)
        opts = run_options(cfg, shape, mesh, variant,
                           **(opt_overrides or {}))
        for pc in cost_pieces(cfg, shape, rules, opts):
            t1 = time.time()
            prec = {"name": pc.name, "multiplier": pc.multiplier}
            prec.update(trace(pc.fn, *pc.specs))
            prec["lower_s"] = round(time.time() - t1, 2)
            rec["pieces"].append(prec)
        comp = compose_pieces(rec["pieces"])
        rec["composed"] = comp
        wsh = 16 if "serving_tp" in variant else 0
        ab = analytic_bytes(cfg, shape, weight_shards=wsh)
        rec["analytic_bytes"] = ab
        # analytic (flash-tiled) bytes determine the memory term; the
        # traced (unfused) bytes are reported as the upper bound.
        rec["terms"] = roofline_terms(comp["flops"], ab["total"],
                                      comp["collective_bytes"])
        rec["terms_hlo_bytes"] = roofline_terms(
            comp["flops"], comp["bytes_accessed"],
            comp["collective_bytes"])
        mf = model_flops(cfg, shape)
        rec["model_flops_global"] = mf
        rec["model_flops_per_dev"] = mf / CHIPS
        rec["params_total"] = param_count(cfg)
        rec["params_active"] = active_param_count(cfg)
        rec["useful_ratio"] = (mf / CHIPS) / comp["flops"] \
            if comp["flops"] else 0.0
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = "" if variant == "baseline" else f"{variant}__"
    (out_dir / f"{prefix}{arch}__{shape_name}.json").write_text(
        json.dumps(rec, indent=1))
    t = rec.get("terms", {})
    print(f"[roofline] {arch} x {shape_name}: {rec['status']} "
          f"dominant={t.get('dominant')} bound={t.get('bound_s', 0):.4f}s "
          f"({rec['total_s']}s)", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=OUT_DEFAULT)
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    if args.all:
        from repro_torch.configs import get_config, supported_shapes
        from repro_torch.configs.all_archs import ALL_ARCH_IDS
        prefix = "" if args.variant == "baseline" else f"{args.variant}__"
        failures = []
        for arch in ALL_ARCH_IDS:
            for shape_name in supported_shapes(get_config(arch)):
                f = out / f"{prefix}{arch}__{shape_name}.json"
                if f.exists() and not args.force:
                    if json.loads(f.read_text()).get("status") == "ok":
                        print(f"[skip] {arch} x {shape_name}", flush=True)
                        continue
                cmd = [sys.executable, "-m",
                       "repro_torch.launch.roofline_run", "--arch", arch,
                       "--shape", shape_name, "--out", args.out,
                       "--variant", args.variant]
                if subprocess.run(cmd, env={**os.environ}).returncode:
                    failures.append((arch, shape_name))
        print("FAILURES:" if failures else "roofline sweep complete",
              failures or "")
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = run_cell(args.arch, args.shape, out, args.variant)
    sys.exit(0 if rec["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
