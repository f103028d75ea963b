"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the root
of the checkout (listed in ``.gitignore``).  The library's file name
carries a hash of its source, of every header of ``csrc/`` (which a
source may include) and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  The sources link only the
CUDA runtime: the one call outside it (``cuTensorMapEncodeTiled``, for
TMA) is fetched at run time through ``cudaGetDriverEntryPoint``.
``build`` starts one ``nvcc`` per missing library, all at once, and
waits for them together.  A variant (``VARIANTS``) is a source built
again with extra flags into a library of its own, never loaded by the
wrappers: ``wkv6_steps`` is ``csrc/wkv6.cu`` with its per-step clock
counters compiled in (``WKV6_STEP_CLOCKS``), ``wkv6_bwd_steps``
``csrc/wkv6_bwd.cu`` with its (``WKV6_BWD_STEP_CLOCKS``), and
``wkv6_bwd_cmax8`` that source with its gradient kernels compiled for
clusters of up to 8 alone (``WKV6_BWD_CMAX8``).

Importing this module touches no CUDA: the CPU tests import it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("spm_matmul", "flash_attention", "flash_attention_bwd", "wkv6",
           "wkv6_bwd", "stamp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 900
# variant library -> (its source, the flags it adds)
VARIANTS = {"wkv6_steps": ("wkv6", ("-DWKV6_STEP_CLOCKS",)),
            "wkv6_bwd_steps": ("wkv6_bwd", ("-DWKV6_BWD_STEP_CLOCKS",)),
            "wkv6_bwd_cmax8": ("wkv6_bwd", ("-DWKV6_BWD_CMAX8",))}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_and_flags(name: str):
    source, extra = VARIANTS.get(name, (name, ()))
    return CSRC / f"{source}.cu", NVCC_FLAGS + extra


def library_path(name: str) -> Path:
    """``build/repro_torch/lib<name>-<hash>.so``: the hash covers the
    source (``csrc/<name>.cu``, or a variant's), every ``csrc/*.cuh``
    and the flags."""
    source, flags = _source_and_flags(name)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns each
    compiled source's compiler messages (``-Xptxas -v`` register and
    spill counts when ``ptxas_verbose``).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            source, flags = _source_and_flags(name)
            cmd = [nvcc_path(), *flags,
                   *(("-Xptxas", "-v") if ptxas_verbose else ()),
                   "-o", str(tmp), str(source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        logs = {}
        for name, (proc, tmp, out) in jobs.items():
            text, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
            os.replace(tmp, out)
            logs[name] = text
        return logs
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a source of ``csrc`` or a variant),
    built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
