"""Run one cell of the port's benchmark on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers the check compared, each with its limit, are
the last lines of standard error.  The program's kernels build into
``build/`` of the checkout (the first run there compiles), as does any
other cache.  Without a CUDA card, or without the cards the cell asks
for, it prints no result and exits 2.
"""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"


def environment() -> None:
    """The serving plan's defaults (no tuned plan read from ``HOME``),
    no program trace, and every compiler cache inside the checkout."""
    os.environ["REPRO_AUTOTUNE"] = "0"
    os.environ.pop("REPRO_TRACE", None)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


if __name__ == "__main__":
    environment()
    # this file's folder would shadow standard modules (trace, ...)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], ROOT, T_PROCESS))
