"""The fault-tolerant training runtime of the port (the reference's
``runtime/trainer.py``).

Wires together: model (models/), optimizer (optim/), data (data/),
checkpointing (checkpoint/), the fault handlers (runtime/fault.py) and
the chaos harness (resilience/chaos.py).  Designed so a
preempted/crashed job relaunched with `Trainer.run()` resumes
bit-exact: deterministic data (pure function of step), full
(params, opt_state, step) in the checkpoint, periodic + preemption
saves, and a non-finite-loss guard that *retries* a poisoned step
instead of skipping its batch — a transient NaN therefore changes
nothing about the final parameters, which is what lets the chaos soak
demand bit-exact equality against an undisturbed run.

The step runs eagerly on ``device`` (CUDA unless the caller asks for
the CPU), where the reference jits it.  Batches cross into torch at the
step's boundary: the dataset's numpy int32 tokens and targets become
``torch.long`` tensors on the device.  Bit-exact resumption needs a
deterministic step: the kernels' sums run in a fixed order, and the one
accumulating scatter of the backward — the embedding lookup's gradient
— goes through ``models.common.EmbedLookup``, whose ``index_put_`` runs
under ``torch.use_deterministic_algorithms`` (serial on the CPU, where
autograd's own runs atomic adds from many threads; the sort-based
kernel on CUDA).  ``chip_smoke.py`` phase 9 holds a resumed run on the
card to an undisturbed one bit for bit.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch import compat
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.models import lm as lm_mod
from repro_torch.optim.adamw import adamw_init, make_train_step
from repro_torch.resilience.chaos import (FaultPlan, TransientIOFault,
                                          corrupt_checkpoint,
                                          corrupt_plan_cache)
from repro_torch.runtime.fault import PreemptionGuard, StragglerMonitor


class NonFiniteLossError(RuntimeError):
    """K consecutive non-finite losses: the divergence is persistent,
    not transient — aborting beats looping forever on a poisoned
    step."""


@dataclass
class TrainerState:
    params: Any
    opt_state: Any
    step: int = 0


@dataclass
class Trainer:
    cfg: ModelConfig
    tcfg: TrainConfig
    dcfg: DataConfig
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    opts: lm_mod.RunOptions = field(default_factory=lm_mod.RunOptions)
    log_every: int = 10
    on_metrics: Optional[Callable[[int, Dict], None]] = None
    trace: Optional[Any] = None     # obs.TraceRecorder (wall-clock us)
    chaos: Optional[FaultPlan] = None   # resilience: fault injection
    max_nonfinite: int = 3          # consecutive bad steps -> abort
    deadline: Optional[Any] = None  # resilience.DeadlineMonitor: each
    # training step walks the same record->warn ladder as serving
    # (train never sheds; the overrun summary is the deliverable)
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = compat.resolve_device(self.device)
        self.dataset = SyntheticLMDataset(self.dcfg)
        self.ckpt = (CheckpointManager(self.ckpt_dir, trace=self.trace)
                     if self.ckpt_dir else None)
        self.guard = PreemptionGuard()
        self.straggler = StragglerMonitor(trace=self.trace)
        if self.chaos is not None and self.chaos.trace is None:
            self.chaos.trace = self.trace
        self.nonfinite_steps: List[int] = []
        self._step_fn = make_train_step(self.cfg, self.tcfg, self.opts)

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0) -> TrainerState:
        params = lm_mod.init_params(self.cfg, seed, self.device)
        return TrainerState(params, adamw_init(params), 0)

    def restore_or_init(self) -> TrainerState:
        state = self.init_state(self.tcfg.seed)
        if self.ckpt and self.ckpt.latest_step() is not None:
            tree = {"params": state.params, "opt": state.opt_state}
            restored, step = self.ckpt.restore(tree)
            return TrainerState(restored["params"], restored["opt"], step)
        return state

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The dataset's batch for ``step`` as long tensors on the
        trainer's device."""
        return {k: torch.from_numpy(v).to(self.device, torch.long)
                for k, v in self.dataset.batch_at(step).items()}

    # ------------------------------------------------------------ chaos

    def _apply_faults(self, step: int) -> float:
        """Fire the fault plan's injections for this step; returns the
        loss_scale to feed the train step (NaN for a poisoned step)."""
        scale = 1.0
        for f in self.chaos.take(step):
            if f.kind == "nan_loss":
                scale = float("nan")
            elif f.kind == "preempt":
                self.guard.trigger_for_test()
            elif f.kind == "straggler":
                time.sleep(f.duration_s)
            elif f.kind == "io_error" and self.ckpt:
                self.ckpt.fault_hook = TransientIOFault(count=f.count)
            elif f.kind == "ckpt_corrupt" and self.ckpt:
                self.ckpt.wait()    # damage a *published* checkpoint
                corrupt_checkpoint(self.ckpt.dir,
                                   mode=f.mode or "array",
                                   rng=self.chaos.rng)
            elif f.kind == "cache_corrupt":
                from repro_torch.tuning.plan_cache import (
                    CACHE_PATH_ENV, DEFAULT_CACHE_PATH)
                corrupt_plan_cache(
                    os.path.expanduser(os.environ.get(
                        CACHE_PATH_ENV, DEFAULT_CACHE_PATH)),
                    mode=f.mode or "garbage")
        return scale

    # -------------------------------------------------------------- run

    def run(self, num_steps: int) -> Dict[str, List[float]]:
        state = self.restore_or_init()
        # step_s: the straggler monitor's running mean, as the
        # reference records it; step_time_s: each step's own time
        history: Dict[str, List[float]] = {"loss": [], "step_s": [],
                                           "step_time_s": []}
        t_wall = time.monotonic()
        consecutive_nonfinite = 0
        while state.step < num_steps:
            scale = (self._apply_faults(state.step)
                     if self.chaos is not None else 1.0)
            batch = self.batch_at(state.step)
            self.straggler.step_start()
            t_step = time.monotonic()
            if self.trace is not None:
                self.trace.begin(f"step{state.step}", track="trainer",
                                 cat="train_step", step=state.step)
            params, opt, metrics = self._step_fn(
                state.params, state.opt_state, batch, scale)
            loss = float(metrics["loss"])   # blocks on device results
            finite = bool(metrics.get("finite", True))
            if self.trace is not None:
                self.trace.end("trainer")
                self.trace.counter("loss", loss)
            if not finite:
                # no update was made; retry the same step — the batch
                # is a pure function of the step counter, so a
                # transient fault leaves the trajectory untouched
                consecutive_nonfinite += 1
                self.nonfinite_steps.append(state.step)
                state = TrainerState(params, opt, state.step)
                self.straggler.step_end(state.step)
                if self.trace is not None:
                    self.trace.instant(
                        "nonfinite_skipped", track="trainer",
                        step=state.step, loss=loss,
                        consecutive=consecutive_nonfinite)
                if consecutive_nonfinite >= self.max_nonfinite:
                    raise NonFiniteLossError(
                        f"{consecutive_nonfinite} consecutive "
                        f"non-finite losses at step {state.step}")
                continue
            consecutive_nonfinite = 0
            dt_step = time.monotonic() - t_step
            history["step_time_s"].append(dt_step)
            state = TrainerState(params, opt, state.step + 1)
            slow = self.straggler.step_end(state.step)
            # deadline ladder (skip the first step: it pays the kernels'
            # first calls).  training has no batch to shed, so "shed"
            # only escalates the message — the summary is the
            # structured deliverable
            if self.deadline is not None and state.step > 1:
                action = self.deadline.observe(state.step, dt_step)
                if action in ("warn", "shed"):
                    print(f"deadline overrun at step {state.step}: "
                          f"{dt_step * 1e3:.2f} ms > "
                          f"{self.deadline.deadline_s * 1e3:.2f} ms"
                          + (" [persistent]" if action == "shed"
                             else ""))
            history["loss"].append(loss)
            history["step_s"].append(
                self.straggler.mean_step_s or 0.0)
            if self.on_metrics:
                self.on_metrics(state.step, metrics)
            if self.log_every and state.step % self.log_every == 0:
                print(f"step {state.step:5d} loss {loss:.4f} "
                      f"mean_step {self.straggler.mean_step_s:.3f}s"
                      + (" [STRAGGLER]" if slow else ""))
            if self.ckpt and (state.step % self.ckpt_every == 0
                              or self.guard.preempted):
                self.ckpt.save(state.step,
                               {"params": state.params,
                                "opt": state.opt_state},
                               blocking=self.guard.preempted)
            if self.guard.preempted:
                print(f"preempted at step {state.step}; "
                      f"checkpoint saved, exiting cleanly")
                break
        if self.ckpt:
            self.ckpt.save(state.step, {"params": state.params,
                                        "opt": state.opt_state})
            self.ckpt.wait()
        history["wall_s"] = [time.monotonic() - t_wall]
        self.final_state = state
        return history
