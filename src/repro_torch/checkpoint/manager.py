"""Checkpointing for fault-tolerant training, the port's copy of the
reference's ``checkpoint/manager.py``, with the same on-disk format.

Guarantees:
  * atomicity: a checkpoint directory is written under a tmp name and
    os.rename'd into place — a crash mid-save never corrupts `latest`,
  * async: saves run on a background thread from host copies so the
    train loop isn't blocked (`save(..., blocking=False)`); a failed
    background save is never silent — the exception is captured and
    re-raised from the next `wait()` (or the `save()` that implies it),
  * integrity: `manifest.json` carries a CRC32 per leaf over its stored
    bits, verified on restore; a corrupt/truncated/partial checkpoint
    raises :class:`CheckpointCorruptError` (so does a leaf whose shape
    is not the restoring model's; a leaf-count mismatch is an
    ``AssertionError``, as in the reference),
  * self-healing restore: `restore(step=None)` walks checkpoints
    newest-first and falls back to the newest *intact* one when
    `latest` or a step dir is damaged (every fallback is an obs
    instant on the ``ckpt`` track),
  * transient-I/O tolerance: every read/write primitive is wrapped in
    `resilience.retry_transient` (OSError family only — corruption is
    not transient and is never retried),
  * retention: keep_n newest checkpoints are retained,
  * multi-process: a tree with DTensor leaves is saved by every rank of
    the running process group, each leaf gathered whole; rank 0 alone
    writes, and every rank waits at a barrier until the checkpoint is
    published (before `save` returns, or in `wait()` for a background
    save).  `restore(..., shardings=)` lays each leaf out on a mesh of
    the caller's (the elastic re-mesh path): the device count may
    differ from the one that saved.

Layout:  <dir>/step_<N>/  { manifest.json, arr_<i>.npy ... }
         <dir>/latest     (text file with the step number)

Leaves are numbered in the reference's flatten order (sorted dict keys,
``models.spec.tree_items``), a bf16 leaf is stored as its ``uint16``
bits with ``"bfloat16"`` in the manifest's dtypes, and restore reads
those bits back without ``ml_dtypes``: a checkpoint written by either
package restores in the other.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import warnings
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.spec import tree_from_items, tree_items
from repro_torch.resilience.retry import retry_transient


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (bad manifest,
    missing/truncated array file, or checksum mismatch)."""


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf as (stored array, dtype name): bf16 as
    its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storage(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor of the manifest's dtype."""
    arr = np.array(arr)     # a writable C-ordered copy, 0-d kept
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise CheckpointCorruptError(
            f"stored dtype {arr.dtype} does not hold {dtype}")
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 trace: Optional[Any] = None,
                 io_attempts: int = 3, io_base_delay: float = 0.005):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.trace = trace              # obs.TraceRecorder (or None)
        self.io_attempts = io_attempts
        self.io_base_delay = io_base_delay
        # chaos seam: called as hook(op, path) before each I/O
        # primitive; a TransientIOFault here must be absorbed by the
        # retry wrapper below
        self.fault_hook: Optional[Callable[[str, Any], None]] = None
        self._thread: Optional[threading.Thread] = None
        self._bg_error: Optional[BaseException] = None
        # a background save of DTensor leaves owes the group a barrier
        self._barrier_due = False

    # ----------------------------------------------------------- obs/io

    def _instant(self, name: str, **args: Any) -> None:
        if self.trace is not None:
            self.trace.instant(name, track="ckpt", **args)

    def _io(self, op: str, path: Any, fn: Callable[[], Any]) -> Any:
        """One retried I/O primitive; retries emit ``io_retry``
        instants so recoveries show up in the trace."""
        def attempt():
            if self.fault_hook is not None:
                self.fault_hook(op, path)
            return fn()

        return retry_transient(
            attempt, attempts=self.io_attempts,
            base_delay=self.io_base_delay,
            give_up_on=(FileNotFoundError,),
            on_retry=lambda k, e, d: self._instant(
                "io_retry", op=op, attempt=k, error=str(e),
                backoff_s=d))

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Write ``tree`` (nested dicts of tensors) as step ``step``.
        The host copies are taken here, before any background write
        starts.  DTensor leaves are gathered whole on every rank (a
        collective: every rank of the group calls ``save``); rank 0
        writes them, and every rank waits for the write at a barrier."""
        self.wait()               # never overlap two writers (same dir)
        items = list(tree_items(tree))
        grouped = any(isinstance(leaf, DTensor) for _, leaf in items)
        if grouped:
            items = [(path, leaf.full_tensor()
                      if isinstance(leaf, DTensor) else leaf)
                     for path, leaf in items]
        writes = not grouped or dist.get_rank() == 0
        host = [(path, _to_host(leaf)) for path, leaf in items] \
            if writes else []
        if blocking:
            if writes:
                self._write(step, host)
            if grouped:
                dist.barrier()
            return
        self._barrier_due = grouped
        if writes:
            self._thread = threading.Thread(
                target=self._write_bg, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join any in-flight background save (and, for DTensor leaves,
        meet the group at its barrier); if it failed, re-raise its
        exception here (a lost checkpoint must never be silent)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_due:
            self._barrier_due = False
            dist.barrier()
        if self._bg_error is not None:
            err, self._bg_error = self._bg_error, None
            raise err

    def _write_bg(self, step: int, host: list) -> None:
        try:
            self._write(step, host)
        except BaseException as e:          # noqa: BLE001 — re-raised
            self._bg_error = e              # from wait()

    def _write(self, step: int, host: list) -> None:
        final = self.dir / f"step_{step}"
        tmp = self.dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        views = [arr for _, (arr, _) in host]
        manifest = {"step": step,
                    "treedef": " ".join(path for path, _ in host),
                    "n_leaves": len(host),
                    "dtypes": [dt for _, (_, dt) in host],
                    "checksums": [_crc(v) for v in views]}
        for i, view in enumerate(views):
            self._io("save_array", tmp / f"arr_{i}.npy",
                     lambda v=view, i=i: np.save(
                         tmp / f"arr_{i}.npy", v, allow_pickle=False))
        self._io("write_manifest", tmp / "manifest.json",
                 lambda: (tmp / "manifest.json").write_text(
                     json.dumps(manifest)))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic publish
        (self.dir / ".latest_tmp").write_text(str(step))
        os.rename(self.dir / ".latest_tmp", self.dir / "latest")
        self._instant("ckpt_saved", step=step, n_leaves=len(host))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self):
        return [int(p.name.split("_")[1])
                for p in self.dir.glob("step_*") if p.is_dir()]

    def latest_step(self) -> Optional[int]:
        """Newest step worth *trying* (the ``latest`` pointer if its
        dir exists, else the newest step dir); deep verification
        happens in restore."""
        steps = self.all_steps()
        f = self.dir / "latest"
        if f.exists():
            try:
                step = int(f.read_text().strip())
            except ValueError:
                step = None
            if step is not None and (self.dir / f"step_{step}").is_dir():
                return step
        return max(steps) if steps else None

    def _candidates(self) -> List[int]:
        """Steps to try, newest-first, `latest`-pointer hint first."""
        steps = sorted(self.all_steps(), reverse=True)
        hint = self.latest_step()
        if hint is not None and hint in steps:
            steps.remove(hint)
            steps.insert(0, hint)
        return steps

    def _read_manifest(self, d: pathlib.Path) -> dict:
        try:
            raw = self._io("read_manifest", d / "manifest.json",
                           lambda: (d / "manifest.json").read_text())
            manifest = json.loads(raw)
        except FileNotFoundError as e:
            raise CheckpointCorruptError(
                f"{d}: manifest missing (partial save?)") from e
        except ValueError as e:
            raise CheckpointCorruptError(
                f"{d}: manifest unreadable: {e}") from e
        if not isinstance(manifest, dict) or "n_leaves" not in manifest:
            raise CheckpointCorruptError(f"{d}: manifest mis-shaped")
        return manifest

    def _read_leaf(self, d: pathlib.Path, i: int,
                   manifest: dict) -> np.ndarray:
        path = d / f"arr_{i}.npy"
        try:
            arr = self._io("read_array", path,
                           lambda: np.load(path, allow_pickle=False))
        except FileNotFoundError as e:
            raise CheckpointCorruptError(f"{path}: missing") from e
        except (ValueError, EOFError) as e:
            raise CheckpointCorruptError(
                f"{path}: unreadable ({e})") from e
        sums = manifest.get("checksums")
        if sums is not None:
            got = _crc(arr)
            if got != sums[i]:
                raise CheckpointCorruptError(
                    f"{path}: checksum mismatch "
                    f"({got:#010x} != {sums[i]:#010x})")
        return arr

    def verify(self, step: int) -> bool:
        """Deep integrity check of one checkpoint; raises
        :class:`CheckpointCorruptError` on any damage."""
        d = self.dir / f"step_{step}"
        if not d.is_dir():
            raise CheckpointCorruptError(f"{d}: no such checkpoint")
        manifest = self._read_manifest(d)
        for i in range(manifest["n_leaves"]):
            self._read_leaf(d, i, manifest)
        return True

    def _restore_step(self, step: int, leaves_like: list,
                      shard_leaves: list) -> list:
        d = self.dir / f"step_{step}"
        if not d.is_dir():
            raise CheckpointCorruptError(f"{d}: no such checkpoint")
        manifest = self._read_manifest(d)
        if manifest["n_leaves"] != len(leaves_like):
            raise AssertionError(
                f"checkpoint has {manifest['n_leaves']} leaves, model "
                f"needs {len(leaves_like)}")
        dtypes = manifest.get("dtypes")
        out = []
        for i, (like, sh) in enumerate(zip(leaves_like, shard_leaves)):
            arr = self._read_leaf(d, i, manifest)
            t = _from_storage(arr, dtypes[i] if dtypes else str(arr.dtype))
            if tuple(t.shape) != tuple(like.shape):
                raise CheckpointCorruptError(
                    f"{d}/arr_{i}.npy: shape {tuple(t.shape)} != "
                    f"{tuple(like.shape)}")
            if sh is None:
                out.append(t.to(device=like.device, dtype=like.dtype))
                continue
            # every rank read the whole leaf: each keeps its own shard
            mesh, placements = sh
            out.append(distribute_tensor(
                t.to(device=mesh.device_type, dtype=like.dtype), mesh,
                placements, src_data_rank=None))
        return out

    def restore(self, like_tree: Any, step: Optional[int] = None,
                shardings: Any = None):
        """Restore into the structure, devices and dtypes of
        ``like_tree``; returns (tree, step).  ``shardings`` (a tree
        matching ``like_tree`` of ``(DeviceMesh, placements)``) lays
        each leaf out as a DTensor on its mesh's device type instead:
        the elastic re-mesh path.

        With ``step=None`` this is self-healing: candidates are tried
        newest-first and a corrupt/partial checkpoint falls back to the
        next intact one (instant ``ckpt_fallback`` per skip).  An
        explicit ``step`` is an exact request — corruption raises."""
        items = list(tree_items(like_tree))
        if shardings is None:
            shard_leaves = [None] * len(items)
        else:
            by_path = dict(tree_items(shardings))
            if set(by_path) != {path for path, _ in items}:
                raise ValueError("shardings must match like_tree's leaves")
            shard_leaves = [by_path[path] for path, _ in items]
        candidates = [step] if step is not None else self._candidates()
        assert candidates, "no checkpoint found"
        last_err: Optional[Exception] = None
        for i, s in enumerate(candidates):
            try:
                out = self._restore_step(s, [leaf for _, leaf in items],
                                         shard_leaves)
                self._instant("ckpt_restored", step=s, fallbacks=i)
                return tree_from_items(like_tree, {
                    path: t for (path, _), t in zip(items, out)}), s
            except CheckpointCorruptError as e:
                last_err = e
                if step is not None:
                    raise
                self._instant("ckpt_fallback", bad_step=s,
                              error=str(e))
                warnings.warn(
                    f"checkpoint step {s} is corrupt ({e}); "
                    "falling back to the previous intact one",
                    RuntimeWarning, stacklevel=2)
        raise CheckpointCorruptError(
            f"no intact checkpoint under {self.dir} "
            f"(tried {candidates})") from last_err
