"""The harness finds every piece by its name, refuses to run without a
card, and loads neither JAX nor the JAX package ``repro``."""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TINY_CONFIGS, TINY_TRAFFIC
from portbench import harness

NEW_METRIC = '''"""tokens_total (tokens): output tokens of the window."""


def read(run):
    return float(run.window["tokens"])
'''

RUN_TINY = '''
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), sys.argv[2]]
import torch
from portbench import harness
from portbench.traffic import batch_serve
batch_serve.WARMUP_S = 0.0
cell = harness.load_cell(root, sys.argv[3])
res = harness.execute(cell, 2**40 + 1, 0.3, False, torch.device("cpu"),
                      time.perf_counter())
print(json.dumps({"harness": harness.__file__, "result": res,
                  "modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": harness.forbidden_modules()}))
'''


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def copy_benchmark(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def run_tiny(root, cell):
    out = subprocess.run([sys.executable, "-c", RUN_TINY, str(root),
                          str(ROOT / "src"), cell], capture_output=True,
                         text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "REPRO_AUTOTUNE": "0",
                              "HOME": str(root)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_new_cell_and_metric_are_found_with_no_edit(tmp_path):
    copy_benchmark(tmp_path)
    before = digest(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "tiny-new.json").write_text(json.dumps(
        TINY_CONFIGS["rwkv"]))
    (pb / "workloads" / "tiny-new.chat.json").write_text(json.dumps(
        dict(TINY_TRAFFIC, traffic="chat")))
    (pb / "metrics" / "tokens_total.py").write_text(NEW_METRIC)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-new", "source": "test",
                            "file": "portbench/configs/tiny-new.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-new.chat", "config": "tiny-new",
                              "traffic": "chat", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "tokens_total", "unit": "tokens",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["tiny-new.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    got = run_tiny(tmp_path, "tiny-new.chat")
    assert got["harness"].startswith(str(tmp_path))
    res = got["result"]
    assert res["correct"], res["compared"]
    assert res["metrics"]["tokens_total"]["value"] > 0
    # tok_s and setup_s list no cells, so they hold for the new one too;
    # ttft_ms and itl_p95_ms list theirs
    assert set(res["metrics"]) == {"tok_s", "setup_s", "tokens_total"}
    # entries were added to BENCHMARK.json; no file of portbench/ changed
    before.pop("BENCHMARK.json")
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_nothing_the_harness_runs_loads_jax_or_repro(tmp_path):
    copy_benchmark(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "tiny-vlm.json").write_text(json.dumps(
        TINY_CONFIGS["vlm"]))
    (pb / "workloads" / "tiny-vlm.t.json").write_text(json.dumps(
        dict(TINY_TRAFFIC, traffic="t", image_positions=4)))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-vlm.t", "config": "tiny-vlm",
                              "traffic": "t", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    got = run_tiny(tmp_path, "tiny-vlm.t")
    assert "repro_torch" in got["modules"]
    assert not set(got["modules"]) & {"jax", "jaxlib", "flax", "repro"}
    assert got["forbidden"] == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch.models", "reprox", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]\n"
            "import portbench.reference.vlm, portbench.reference.rwkv\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(eval(out.stdout))
    assert not mods & {"repro_torch", "repro", "jax"}, mods


@pytest.mark.parametrize("where", ["checkout", "benchmark files alone"])
def test_no_card_no_result(tmp_path, where):
    root = ROOT
    if where != "checkout":
        copy_benchmark(tmp_path)
        root = tmp_path
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "rwkv6-1.6b.long-doc", "--seed", str(2**40), "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                          "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""


def test_benchmark_json_follows_its_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert (ROOT / "portbench" / "workloads" / f"{w['name']}.json") \
            .is_file()
        assert len(w["why"]) <= 200
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert {"tok_s", "ttft_ms", "itl_p95_ms", "setup_s"} <= e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", names)) <= names
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) == {
            w["name"] for w in spec["workloads"]
            if w["name"] in m["workloads"]}
