"""wkv6's gradient in the port against the JAX package's (CPU, small
sizes), and the routes that carry it.

* ``wkv_grad_plain`` (autograd through the port's exact recurrence,
  the backward kernel's plain version) against ``jax.grad`` through the
  reference's ``repro.kernels.wkv6.ref.wkv6_ref`` (``lax.scan``): the
  same numpy-seeded inputs, fp32, K 32, 64 and 128, a ragged S, with
  and without the final state's gradient; each gradient within the
  repo's fp32 tolerance (``conftest.KERNEL_TOLERANCES``: 1e-5 of its
  largest magnitude).
* ``tolerance.wkv_bwd_chunked_model`` and
  ``tolerance.wkv_bwd_cluster_model``, the two backward kernels'
  arithmetic in torch (the ``fma`` path's chunk walk; the
  ``tensor_core`` path's folds over a cluster's groups, anchored
  sub-tiles and tf32 splits), against that plain version under half the
  allowance ``chip_smoke.py`` holds the kernels to, and each of the
  backward's planted faults caught by the same check.
* On a faked card (the device checks monkeypatched, launches replaced
  by the plain versions, as ``tests/test_torch_train.py`` does), one
  reduced rwkv6 training step equals the CPU's: parameters, optimizer
  state and loss, bit for bit.
* On ``meta`` (the dry run), wkv6 traces the chunked form: its op count
  does not grow with the sequence, and a full-sequence rwkv6 dry-run
  cell traces ok far inside the sweep's limit.
* The backward's C entries, ctypes signatures and shared-memory plans
  against ``csrc/wkv6_bwd.cu``; ``bwd_dispatch``'s routes, and the
  wrapper launching the routed entry with its rows (C entries replaced
  by recorders).
"""
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import KERNEL_TOLERANCES
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.core import gpu_mapping
from repro_torch.kernels import _build, tolerance
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch.dryrun import CELL_TIMEOUT_S
from test_torch_train import (TCFG, _fake_card, _opts, _pbatch,
                              _port_state, _setup)

TOL = KERNEL_TOLERANCES["float32"]
ROOT = Path(__file__).resolve().parents[1]


def _inputs(B, S, H, K, seed, with_ds):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, K)) for _ in range(3))
    w = -np.exp(0.8 * rng.standard_normal((B, S, H, K)) - 1.0)
    u = 0.3 * rng.standard_normal((H, K))
    dy = rng.standard_normal((B, S, H, K))
    ds = 0.1 * rng.standard_normal((B, H, K, K)) if with_ds else None
    f = np.float32
    return ([a.astype(f) for a in (r, k, v, w, u, dy)],
            None if ds is None else ds.astype(f))


def _jax_grads(r, k, v, w, u, dy, ds):
    def loss(r, k, v, w, u):
        y, s = jax_wkv6_ref(r, k, v, w, u)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(s * ds)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("B,S,H,K", [(2, 24, 2, 32), (1, 37, 2, 64),
                                     (1, 16, 1, 128)])
def test_plain_gradient_matches_jax_grad_of_the_reference(B, S, H, K,
                                                          with_ds):
    (r, k, v, w, u, dy), ds = _inputs(B, S, H, K, S + K, with_ds)
    want = _jax_grads(r, k, v, w, u, dy, ds)
    got = wkv_ops.wkv_grad_plain(
        *(torch.from_numpy(a) for a in (r, k, v, w, u, dy)),
        None if ds is None else torch.from_numpy(ds))
    for name, g, j in zip(tolerance.WKV_GRADS, got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), j) < TOL, (name, _rel(g.numpy(), j))


BWD_MODELS = {"chunked": tolerance.wkv_bwd_chunked_model,
              "cluster": tolerance.wkv_bwd_cluster_model}


@pytest.mark.parametrize("model", sorted(BWD_MODELS))
@pytest.mark.parametrize("decay", ["model", "reference"])
@pytest.mark.parametrize("B,S,H,K,dtype,with_ds", [
    (1, 100, 2, 64, torch.float32, True),      # ragged: 32-row chunks
    (2, 64, 2, 32, torch.float32, False),      # one 64-row chunk
    (1, 48, 2, 128, torch.float32, True),      # 16-row chunks
    (1, 96, 4, 64, torch.bfloat16, False),
    (1, 520, 1, 64, torch.bfloat16, True),     # 2 groups of 64, ragged
    (1, 200, 1, 128, torch.bfloat16, False),   # 2 groups of 16, ragged
])
def test_backward_kernel_model_within_allowance_and_faults_caught(
        B, S, H, K, dtype, with_ds, decay, model):
    """Each backward kernel's arithmetic, modelled on the CPU (the
    ``fma`` path's ``wkv_bwd_chunked_model``; the ``tensor_core``
    path's ``wkv_bwd_cluster_model``, which takes bf16 r, k, v and dy
    as that path does), against the plain version under half the
    allowance of ``tolerance.check_wkv_grad``; each planted fault of the
    backward reads over 10 of it, the two at a cluster's group boundary
    too where the ``tensor_core`` route walks more than one group."""
    if model == "cluster":
        dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(S * K)
    args = tolerance.wkv_inputs(B, S, H, K, dtype, decay, gen)
    dy = torch.randn(B, S, H, K, generator=gen).to(dtype)
    ds = 0.1 * torch.randn(B, H, K, K, generator=gen) if with_ds else None
    want = wkv_ops.wkv_grad_plain(*args, dy, ds)
    fn = BWD_MODELS[model]
    got = fn(*args, dy, ds)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    worst, _, shares = tolerance.check_wkv_grad(got, want, dtype)
    assert worst < 0.5, shares
    tc = wkv_ops.bwd_dispatch(S, K, torch.bfloat16)
    L = (tc["rows"] if model == "cluster"
         else gpu_mapping.WKV_BWD_ROWS[K])
    group = tc["rows"] * tc["cluster"] if tc["groups"] > 1 else None
    faults = tolerance.wkv_bwd_planted_faults(fn, *args, dy, ds,
                                              L if S > L else S // 2, group)
    assert len(faults) == (5 if group else 3)
    for name, f in faults.items():
        assert tolerance.check_wkv_grad(f, want, dtype)[0] > 10, name


def test_cluster_model_folds_equal_one_walk_over_the_chunks():
    """Within one segment of the states launch the ``tensor_core``
    path's groups change no sum: its CPU model gives the same bits with
    the cluster cut to 2 (four groups) as with 8 (one), since both folds
    add in chunk order; cutting the groups into segments changes only
    the rounding."""
    gen = torch.Generator().manual_seed(3)
    args = tolerance.wkv_inputs(1, 256, 2, 64, torch.bfloat16, "model", gen)
    dy = torch.randn(1, 256, 2, 64, generator=gen).to(torch.bfloat16)
    ds = 0.1 * torch.randn(1, 2, 64, 64, generator=gen)
    one = tolerance.wkv_bwd_cluster_model(*args, dy, ds, cluster=8,
                                          segments=1)
    four = tolerance.wkv_bwd_cluster_model(*args, dy, ds, cluster=2,
                                           segments=1)
    for a, b in zip(one, four):
        assert torch.equal(a, b)
    cut = tolerance.wkv_bwd_cluster_model(*args, dy, ds, cluster=2,
                                          segments=4)
    want = wkv_ops.wkv_grad_plain(*args, dy, ds)
    assert tolerance.check_wkv_grad(cut, want, torch.bfloat16)[0] < 0.5


@pytest.mark.parametrize("S,K,bh,dtype,aligned,want", [
    # rwkv6's training shape: clusters of 2 put all 256 blocks on the
    # card at once (two an SM); the states launch in 4 segments
    (4096, 64, 128, torch.bfloat16, True, ("tensor_core", 32, 2, 64, 4)),
    (256, 64, 128, torch.bfloat16, True, ("tensor_core", 32, 2, 4, 4)),
    (4096, 64, 1, torch.bfloat16, True, ("tensor_core", 32, 8, 16, 16)),
    (600, 64, 2, torch.bfloat16, True, ("tensor_core", 32, 7, 3, 3)),
    (100, 64, 4, torch.bfloat16, True, ("tensor_core", 32, 4, 1, 1)),
    (256, 32, 128, torch.bfloat16, True, ("tensor_core", 32, 2, 4, 4)),
    (256, 128, 8, torch.bfloat16, True, ("tensor_core", 16, 8, 2, 2)),
    (4096, 64, 128, torch.bfloat16, False, ("fma", 32, 1, 1, None)),
    (4096, 64, 128, torch.float32, True, ("fma", 32, 1, 1, None)),
    (64, 128, 1, torch.float32, True, ("fma", 16, 1, 1, None)),
])
def test_bwd_dispatch_routes_bf16_aligned_to_tensor_core_else_fma(
        S, K, bh, dtype, aligned, want):
    route = wkv_ops.bwd_dispatch(S, K, dtype, aligned, bh)
    assert (route["path"], route["rows"], route["cluster"],
            route["groups"], route.get("segments")) == want
    assert route["path"] == wkv_ops.select_path(dtype, aligned)
    if route["path"] == "tensor_core":
        assert route["cluster"] * route["groups"] * route["rows"] >= S
        assert 1 <= route["segments"] <= route["groups"]


def _recording_launch(monkeypatch):
    """``wkv_bwd`` on CPU tensors with the device check passed and each
    C entry replaced by a recorder: (entry name, arguments) per call."""
    calls = []

    def lib(path, backward=False):
        assert backward
        name = wkv_ops.BWD_ENTRIES[path][0]
        return lambda *a: calls.append((name, a)) or 0

    monkeypatch.setattr(wkv_ops, "_check_card", lambda ts: None)
    monkeypatch.setattr(wkv_ops, "_lib", lib)
    monkeypatch.setattr(wkv_ops.wkv, "bwd_launches", 0)
    monkeypatch.setattr(wkv_ops.wkv, "bwd_paths",
                        dict.fromkeys(wkv_ops.PATHS, 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    return calls


def test_bwd_wrapper_launches_the_routed_entry(monkeypatch):
    """The wrapper launches the entry ``bwd_dispatch`` names with its
    rows, counts the launch by path, and sums du's partials: per (b, h,
    chunk) on ``tensor_core``, per (b, h) on ``fma``.  ``_bwd_launch``
    with ``fma``'s route launches that kernel on a bf16 call."""
    calls = _recording_launch(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    fma = wkv_ops.bwd_dispatch(600, 64, torch.float32)
    for dtype, route, entry, rows in (
            (torch.bfloat16, None, "wkv6_bwd_tc_launch", 32),
            (torch.bfloat16, fma, "wkv6_bwd_launch", 32),
            (torch.float32, None, "wkv6_bwd_launch", 32)):
        args = tolerance.wkv_inputs(2, 600, 3, 64, dtype, "model", gen)
        dy = torch.zeros(2, 600, 3, 64, dtype=dtype)
        dr, dk, dv, dw, du = (
            wkv_ops.wkv_bwd(*args, dy) if route is None
            else wkv_ops._bwd_launch(route, *args, dy))
        name, a = calls[-1]
        assert name == entry
        assert a[13:18] == (2, 600, 3, 64, rows)
        if entry == "wkv6_bwd_tc_launch":   # the cluster and segments
            route = wkv_ops.bwd_dispatch(600, 64, dtype, True, 6)
            assert a[18:20] == (route["cluster"], route["segments"])
        assert dr.dtype == dtype and dw.dtype == torch.float32
        assert du.shape == (3, 64)
    assert wkv_ops.wkv.bwd_launches == 3
    assert wkv_ops.wkv.bwd_paths == {"tensor_core": 1, "fma": 2}


def _rwkv_step(cfg, np_params, batch):
    from repro_torch.models import lm as plm
    from repro_torch.optim import adamw as padamw
    from repro_torch.configs import TrainConfig
    step = padamw.make_train_step(cfg, TrainConfig(**TCFG),
                                  _opts(plm.RunOptions))
    return step(*_port_state(cfg, np_params), _pbatch(batch))


def test_faked_card_rwkv_train_step_equals_the_cpus(monkeypatch):
    """One reduced rwkv6 training step through ``WKV6`` (forward and
    backward launches) gives the CPU route's parameters, optimizer state
    and loss: the backward's plain version is the autograd of the CPU
    route's forward."""
    from repro_torch.models.spec import tree_items
    _, cfg, np_params, batch = _setup("rwkv6-1.6b", seed=2)
    want = _rwkv_step(cfg, np_params, batch)
    _fake_card(monkeypatch)
    got = _rwkv_step(cfg, np_params, batch)
    assert wkv_ops.wkv.bwd_launches == cfg.num_layers
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    for tree in (0, 1):
        for (pa, a), (pb, b) in zip(tree_items(got[tree]),
                                    tree_items(want[tree])):
            assert pa == pb and torch.equal(a, b), pa


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _meta_ops(S, chunk, grad):
    ts = [torch.empty(2, S, 4, 64, device="meta") for _ in range(4)]
    u = torch.empty(4, 64, device="meta")
    if grad:
        for t in ts + [u]:
            t.requires_grad_()
    with _OpCount() as count:
        y, state = wkv_ops.wkv(*ts, u, chunk=chunk)
        if grad:
            torch.autograd.grad(y.sum() + state.sum(), ts + [u])
    assert y.shape == (2, S, 4, 64) and y.device.type == "meta"
    return count.ops


@pytest.mark.parametrize("grad", [False, True])
def test_meta_trace_op_count_does_not_grow_with_the_sequence(grad):
    """``meta`` operands trace the chunked form at the caller's chunk:
    the same ops at 8 and 64 chunks, forward and under autograd, and
    fewer than the positions (the per-position plain version traces
    several a position)."""
    short, long_ = _meta_ops(2048, 256, grad), _meta_ops(16384, 256, grad)
    assert short == long_
    assert sum(short.values()) < 2048


def test_meta_rwkv_dry_run_cell_traces_ok_inside_the_limit(tmp_path):
    """A full-sequence rwkv6 cell (train_4k, the 16x16 mesh) traces ok
    in a subprocess, far inside ``CELL_TIMEOUT_S``."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rwkv6-1.6b", "--shape", "train_4k", "--multi-pod", "single",
         "--out", str(tmp_path)],
        cwd=ROOT, env={**__import__("os").environ,
                       "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=CELL_TIMEOUT_S)
    secs = time.monotonic() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert ": ok (" in proc.stdout
    assert secs < CELL_TIMEOUT_S / 4, secs


def test_backward_entry_and_smem_plan_match_the_source():
    """Each backward path's ctypes signature has its C entry's
    parameters in order, and ``WKV_BWD_ROWS``, ``WKV_BWD_TC_ROWS``,
    ``WKV_BWD_THREADS``, ``WKV_BWD_TC_PAD`` and ``wkv_bwd_smem_plan``
    (both paths, the ``tensor_core`` path's two launches) name what
    ``csrc/wkv6_bwd.cu`` is compiled with."""
    import ctypes
    text = (_build.CSRC / "wkv6_bwd.cu").read_text()
    assert set(wkv_ops.BWD_ENTRIES) == set(wkv_ops.PATHS)
    for name, argtypes in wkv_ops.BWD_ENTRIES.values():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           text).group(1)
        kinds = ["ptr" if "*" in p else " ".join(p.split()).rsplit(" ", 1)[0]
                 for p in params.split(",")]
        assert kinds == ["ptr" if t is ctypes.c_void_p else "int"
                         for t in argtypes], name
    assert "wkv6_bwd" in _build.SOURCES
    assert _build.VARIANTS["wkv6_bwd_steps"][0] == "wkv6_bwd"

    def rows(struct):
        return {int(k): int(v) for k, v in re.findall(
            rf"struct {struct}<(\d+)> \{{\s*static constexpr int value = "
            rf"(\d+);", text)}
    assert rows("ChunkRows") == gpu_mapping.WKV_BWD_ROWS
    assert rows("TcRows") == gpu_mapping.WKV_BWD_TC_ROWS
    assert f"constexpr int kThreads = {gpu_mapping.WKV_BWD_THREADS};" in text
    assert (f"constexpr int kTcThreads = {gpu_mapping.WKV_BWD_THREADS};"
            in text)
    assert f"constexpr int kTcPad = {gpu_mapping.WKV_BWD_TC_PAD};" in text
    assert (f"constexpr int kMaxCluster = {gpu_mapping.WKV_MAX_CLUSTER};"
            in text)
    for K, L in gpu_mapping.WKV_BWD_ROWS.items():
        plan = gpu_mapping.wkv_bwd_smem_plan(K)
        assert plan["rows"] == L and plan["fits"]
        assert plan["smem_need"] == 4 * (7 * L * (K + 1) + 2 * K * (K + 1)
                                         + 2 * L * (L + 1) + 2 * L + 4 * K)
    for K, L in gpu_mapping.WKV_BWD_TC_ROWS.items():
        assert f"launch_tc_k<{K}, TcRows<{K}>::value>" in text
        P, PL = K + 8, L + 8
        # fp32: cw, the diagonal dr and dk (then a, a - k dk), two
        # derived operands [L, P]; the state and adjoint [K, P]; dy v^T
        # and A^T [L, PL]; exp2(total), u, Q per channel; g, r u k per
        # row.  bf16: r, k, v, dy [L, P].
        plan = gpu_mapping.wkv_bwd_smem_plan(K, path="tensor_core")
        assert plan["rows"] == L and plan["fits"]
        assert plan["smem_need"] == 4 * (5 * L * P + 2 * K * P + 2 * L * PL
                                         + 3 * K + 2 * L) + 2 * 4 * L * P
        # the log-decay, kd and exp2(total); k and v
        states = gpu_mapping.wkv_bwd_smem_plan(K, path="tensor_core",
                                               states=True)
        assert states["smem_need"] == 4 * (2 * L * P + K) + 2 * 2 * L * P
    # 32 rows at K = 64: two blocks an SM; 64 would hold one
    tc = gpu_mapping.wkv_bwd_smem_plan(64, path="tensor_core")
    assert (tc["smem_need"], tc["resident"]) == (112_640, 2)
    assert gpu_mapping.wkv_bwd_smem_plan(
        64, path="tensor_core", rows=64)["smem_need"] == 204_032
    assert "kBytes + 1024 <= 233472 / 2 ? 2 : 1" in text
    with pytest.raises(ValueError):
        gpu_mapping.wkv_bwd_smem_plan(64, path="wgmma")


def test_cpu_backward_counts_no_launch():
    """On the CPU the gradient is autograd's through the plain version:
    no kernel count moves."""
    before = (wkv_ops.wkv.launches, wkv_ops.wkv.bwd_launches)
    args = [t.requires_grad_() for t in tolerance.wkv_inputs(
        1, 16, 2, 32, torch.float32, "model", torch.Generator().manual_seed(0))]
    y, _ = wkv_ops.wkv(*args)
    y.sum().backward()
    assert all(t.grad is not None for t in args)
    assert (wkv_ops.wkv.launches, wkv_ops.wkv.bwd_launches) == before
