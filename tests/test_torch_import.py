"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro`` (whose name ``repro_torch``
starts with), so the port runs on a GPU machine that has neither."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:\.|\s|,|$)"
    r"|from\s+(?:jax|repro)(?:\.|\s))")


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_source_has_no_jax_or_repro_import(path):
    offenders = [f"{i}: {line.strip()}" for i, line in enumerate(
        path.read_text(encoding="utf-8").splitlines(), 1)
        if _FORBIDDEN.match(line)]
    assert not offenders, offenders


def test_forbidden_pattern_spares_repro_torch():
    assert _FORBIDDEN.match("from repro.models import lm")
    assert _FORBIDDEN.match("import repro.configs")
    assert _FORBIDDEN.match("import jax.numpy as jnp")
    assert _FORBIDDEN.match("    import repro")
    assert not _FORBIDDEN.match("from repro_torch.models import lm")
    assert not _FORBIDDEN.match("import repro_torch")


def test_importing_the_dry_run_starts_no_process_group():
    code = (
        "import torch.distributed as dist\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.roofline_run, repro_torch.launch.specs\n"
        "import repro_torch.analysis.pieces, repro_torch.analysis.comm\n"
        "print(dist.is_initialized())\n"
        "raise SystemExit(1 if dist.is_initialized() else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "False"
