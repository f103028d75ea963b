"""Multi-process helpers of the port's multi-device tests.

``run_ranks`` starts the ranks of a ``torch.distributed`` gloo group,
each a ``python -c`` subprocess with one thread (``OMP_NUM_THREADS=1``)
and a time limit.  The ranks meet through a ``FileStore`` under the
test's ``tmp_path``, not a TCP port, so tests on many pytest workers
never share a rendezvous.  Each rank's code runs with the group started
and ``RANK``, ``WORLD`` and ``OUT`` (the test's ``tmp_path``) bound.

``run_reference`` runs a script of the JAX package with ``n`` host
devices, as the reference's own multi-device tests run theirs.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import time
import uuid

REPO = pathlib.Path(__file__).resolve().parent.parent

_PREAMBLE = """
import os, pathlib
RANK, WORLD = int(os.environ["REPRO_RANK"]), int(os.environ["REPRO_WORLD"])
OUT = pathlib.Path(os.environ["REPRO_OUT"])
from repro_torch.launch.mesh import init_world
init_world("gloo", RANK, WORLD, os.environ["REPRO_STORE"])
"""

_EPILOGUE = """
import torch.distributed as _dist
_dist.barrier()
_dist.destroy_process_group()
"""


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def run_ranks(n: int, code: str, tmp_path, timeout: float = 240.0) -> list:
    """Run ``code`` on ``n`` gloo ranks; returns each rank's stdout.  A
    rank that fails or outlives ``timeout`` (seconds, for the group)
    fails the test with its stderr, and every rank still running is
    killed."""
    out = pathlib.Path(tmp_path)
    store = out / f"store_{uuid.uuid4().hex}"
    script = _PREAMBLE + textwrap.dedent(code) + _EPILOGUE
    procs = [subprocess.Popen(
        [sys.executable, "-c", script], cwd=REPO,
        env=_env(REPRO_RANK=str(r), REPRO_WORLD=str(n),
                 REPRO_OUT=str(out), REPRO_STORE=str(store)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for r, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} of {n} outlived "
                                     f"{timeout} s") from None
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {n} exited "
                                     f"{p.returncode}:\n{stderr[-3000:]}")
            results.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def run_reference(code: str, n_devices: int, *args,
                  timeout: float = 300.0) -> str:
    """Run a script of the JAX package on ``n_devices`` host devices
    (``--xla_force_host_platform_device_count``); returns its stdout."""
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count="
               f"{n_devices}")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                        *map(str, args)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout
