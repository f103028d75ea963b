"""The port's ``checkpoint.manager`` against the reference's (CPU).

Both packages write the same format (one ``.npy`` per leaf in sorted-key
order, bf16 as its uint16 bits, a CRC32 per leaf in the manifest), so
the checks are exact: round trips are bit-identical, a checkpoint
written by either package restores in the other bit for bit, and each
fault raises the reference's exception (a shape mismatch
``CheckpointCorruptError``, a leaf-count mismatch ``AssertionError``).
"""
import json
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointCorruptError as JaxCorrupt
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.models.spec import tree_items
from repro_torch.obs import TraceRecorder
from repro_torch.resilience import (CKPT_CORRUPT_MODES, TransientIOFault,
                                    corrupt_checkpoint)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g)
                       .to(torch.bfloat16),
                       "norm": torch.randn(4, generator=g)},
            "opt": {"count": torch.tensor(7, dtype=torch.int32),
                    "m": {"w": torch.randn(3, 4, generator=g)}}}


def _like(tree):
    return {k: _like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _assert_bits_equal(got, want):
    got, want = list(tree_items(got)), list(tree_items(want))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


def _to_jax(tree):
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return {k: _to_jax(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def _jax_bits(tree):
    return [np.asarray(x).tobytes() for x in jax.tree.leaves(tree)]


def test_round_trip_is_bit_exact(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = _tree()
    cm.save(10, tree)
    got, step = cm.restore(_like(tree))
    assert step == 10
    _assert_bits_equal(got, tree)
    assert got["opt"]["count"].dim() == 0


def test_manifest_matches_the_reference_format(tmp_path):
    tree = _tree()
    CheckpointManager(str(tmp_path / "port")).save(1, tree)
    JaxManager(str(tmp_path / "ref")).save(1, _to_jax(tree))
    mp, mr = (json.loads((tmp_path / d / "step_1" / "manifest.json")
                         .read_text()) for d in ("port", "ref"))
    for key in ("step", "n_leaves", "dtypes", "checksums"):
        assert mp[key] == mr[key], key
    for i in range(mp["n_leaves"]):
        a, b = (np.load(tmp_path / d / "step_1" / f"arr_{i}.npy")
                for d in ("port", "ref"))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree(1)
    JaxManager(str(tmp_path)).save(4, _to_jax(tree))
    got, step = CheckpointManager(str(tmp_path)).restore(_like(tree))
    assert step == 4
    _assert_bits_equal(got, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(2)
    CheckpointManager(str(tmp_path)).save(6, tree)
    jtree = _to_jax(tree)
    got, step = JaxManager(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, jtree))
    assert step == 6
    assert _jax_bits(got) == _jax_bits(jtree)
    assert got["params"]["w"].dtype == jnp.bfloat16


def test_retention_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_n=2)
    t = {"x": torch.zeros(2)}
    for s in (1, 2, 3):
        cm.save(s, t)
    assert sorted(cm.all_steps()) == [2, 3]
    assert cm.latest_step() == 3


def test_async_save_is_atomic_and_copies_first(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    x = torch.arange(1000, dtype=torch.float32)
    cm.save(5, {"x": x}, blocking=False)
    x.zero_()                   # the host copy was taken in save()
    cm.wait()
    assert not list(pathlib.Path(tmp_path).glob(".tmp_*"))
    got, _ = cm.restore({"x": torch.zeros(1000)})
    assert torch.equal(got["x"], torch.arange(1000, dtype=torch.float32))


def test_a_failed_write_leaves_the_latest_intact(tmp_path):
    cm = CheckpointManager(str(tmp_path), io_attempts=1)
    cm.save(1, {"x": torch.ones(3)})
    cm.fault_hook = TransientIOFault(count=1, op_match="write_manifest")
    with pytest.raises(Exception):
        cm.save(2, {"x": torch.full((3,), 2.0)})
    cm.fault_hook = None
    assert cm.latest_step() == 1 and cm.all_steps() == [1]
    got, step = cm.restore({"x": torch.zeros(3)})
    assert step == 1 and torch.equal(got["x"], torch.ones(3))


def test_background_error_is_reraised(tmp_path):
    cm = CheckpointManager(str(tmp_path), io_attempts=1)
    cm.fault_hook = TransientIOFault(count=5)
    cm.save(1, {"x": torch.ones(3)}, blocking=False)
    with pytest.raises(Exception):
        cm.wait()
    cm.wait()                   # raised once, then cleared


def test_transient_io_errors_are_retried(tmp_path):
    rec = TraceRecorder()
    cm = CheckpointManager(str(tmp_path), trace=rec)
    cm.fault_hook = TransientIOFault(count=2)
    cm.save(1, {"x": torch.ones(3)})
    assert [i.name for i in rec.instants].count("io_retry") == 2
    assert cm.verify(1)


def test_shape_mismatch_raises_corrupt_error_as_the_reference(tmp_path):
    CheckpointManager(str(tmp_path / "p")).save(1, {"x": torch.zeros(4)})
    with pytest.raises(CheckpointCorruptError):
        CheckpointManager(str(tmp_path / "p")).restore(
            {"x": torch.zeros(5)}, step=1)
    with pytest.warns(RuntimeWarning), pytest.raises(CheckpointCorruptError):
        CheckpointManager(str(tmp_path / "p")).restore({"x": torch.zeros(5)})
    JaxManager(str(tmp_path / "r")).save(1, {"x": jnp.zeros((4,))})
    with pytest.raises(JaxCorrupt):
        JaxManager(str(tmp_path / "r")).restore({"x": jnp.zeros((5,))},
                                                step=1)


def test_leaf_count_mismatch_asserts_as_the_reference(tmp_path):
    CheckpointManager(str(tmp_path / "p")).save(1, {"x": torch.zeros(4)})
    with pytest.raises(AssertionError):
        CheckpointManager(str(tmp_path / "p")).restore(
            {"x": torch.zeros(4), "y": torch.zeros(1)})
    JaxManager(str(tmp_path / "r")).save(1, {"x": jnp.zeros((4,))})
    with pytest.raises(AssertionError):
        JaxManager(str(tmp_path / "r")).restore(
            {"x": jnp.zeros((4,)), "y": jnp.zeros((1,))})


@pytest.mark.parametrize("mode", CKPT_CORRUPT_MODES)
def test_corruption_falls_back_to_the_newest_intact(tmp_path, mode):
    rec = TraceRecorder()
    cm = CheckpointManager(str(tmp_path), trace=rec)
    cm.save(1, {"x": torch.ones(64)})
    cm.save(2, {"x": torch.full((64,), 2.0)})
    hit = corrupt_checkpoint(tmp_path, mode=mode)
    assert hit == 2
    if mode != "latest":
        with pytest.raises(CheckpointCorruptError):
            cm.verify(2) if mode != "partial" else cm.restore(
                {"x": torch.zeros(64)}, step=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, step = cm.restore({"x": torch.zeros(64)})
    want = 2.0 if mode == "latest" else 1.0
    assert torch.equal(got["x"], torch.full((64,), want))
    assert step == int(want)
    names = [i.name for i in rec.instants]
    assert "ckpt_restored" in names
    assert ("ckpt_fallback" in names) == (mode != "latest")


def test_no_intact_checkpoint_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"x": torch.ones(64)})
    corrupt_checkpoint(tmp_path, mode="manifest")
    with pytest.warns(RuntimeWarning), pytest.raises(CheckpointCorruptError):
        cm.restore({"x": torch.zeros(64)})


def test_restore_keeps_the_like_trees_dtype_and_device(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.ones(2, 2, dtype=torch.bfloat16)})
    got, _ = cm.restore({"w": torch.zeros(2, 2, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
