"""What the benchmark takes from the program (``repro_torch``), one file
per model family (``<family>.py``: ``program_config``), and the steps
every family shares: the kernels built or loaded from the checkout's
build directory, the parameter layout held against the program's, and
the serving options its default plan resolves.  The program is imported
only inside these functions."""
from __future__ import annotations

import importlib


def program_config(family: str, dm: dict):
    """The program's ``ModelConfig`` for the sizes ``dm``."""
    return importlib.import_module(f"portbench.program.{family}") \
        .program_config(dm)


def check_layout(cfg, layout) -> None:
    """Raise unless the program's parameter tree has exactly the leaves
    of ``layout``, with their shapes and dtypes."""
    from repro_torch.models import lm
    from repro_torch.models.spec import tree_items
    want = {path: (tuple(shape), dt) for path, shape, dt, _ in layout}
    got = {path: (tuple(p.shape), p.dtype)
           for path, p in tree_items(lm.model_spec(cfg))}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise RuntimeError(f"the program's parameters differ from the "
                           f"benchmark's layout: {diff[:8]}")


def build_kernels() -> None:
    """Compile what is missing into ``build/repro_torch/`` of the
    checkout (the first run there), else nothing."""
    from repro_torch.kernels import _build
    _build.build()


def serve_options(cfg, arch: str, batch: int, prompt: int, gen: int):
    """``RunOptions`` as ``launch.serve.setup_model`` resolves them for
    a full-width model: the serving plan's defaults (the benchmark runs
    with ``REPRO_AUTOTUNE=0``) and a cache of prompt + gen positions."""
    from repro_torch.models.lm import RunOptions
    from repro_torch.tuning.model import ModelProblem, resolve_model_plan
    problem = ModelProblem(arch, batch, prompt, gen, layers=0,
                           d_model=cfg.d_model, vocab=cfg.vocab_size,
                           dtype=cfg.dtype)
    resolved = resolve_model_plan(cfg, problem, {"chunk_q": None,
                                                 "chunk_kv": None})
    plan = resolved["plan"]
    if resolved["source"] != "defaults":
        raise RuntimeError(f"serving plan from {resolved['source']}, not "
                           f"the defaults")
    return RunOptions(chunk_q=int(plan["chunk_q"]),
                      chunk_kv=int(plan["chunk_kv"]),
                      cache_len=prompt + gen, remat=False,
                      decode_scan=bool(plan["decode_scan"]),
                      mm_tiles=(int(plan["mm_bm"]), int(plan["mm_bn"])))
