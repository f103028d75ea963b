"""The paper's primary contribution, as a composable library (the port's
copy of the reference's ``core`` package):

  schedule.py    static-schedule IR + interference-freedom validation
  scheduler.py   compile-time blocked-matmul scheduler (paper §4.3)
  timing.py      calibrated cycle-accurate phase timing model
  simulator.py   discrete-event executor with seeded DDR4 jitter
  wcet.py        compositional WCET bounds (paper §3.1)
  roofline.py    paper Fig. 3 roofline model
  fmax.py        F_max model fitted to Tables 1-2
  resources.py   FPGA resource model (Fig. 5)
  network_scheduler.py  whole-network schedule, time-triggered table
  gpu_mapping.py the MultiVic execution model on the H100 (the port's
                 counterpart of the reference's ``tpu_mapping.py``)

Every module but ``gpu_mapping`` is a numpy-only copy of the
reference's, held to it bit for bit by
``tests/test_torch_paper_model.py``.
"""
from repro_torch.core.schedule import DMA, Phase, Schedule, core_resource
from repro_torch.core.scheduler import (MatmulProblem, build_matmul_schedule,
                                        schedule_totals, spm_plan)
from repro_torch.core.simulator import SimResult, run_many, simulate
from repro_torch.core.timing import DEFAULT_TIMING, TimingParams
from repro_torch.core.wcet import jitter_bound, wcet, wcet_closed_form

__all__ = [
    "DMA", "Phase", "Schedule", "core_resource", "MatmulProblem",
    "build_matmul_schedule", "schedule_totals", "spm_plan", "SimResult",
    "run_many", "simulate", "DEFAULT_TIMING", "TimingParams",
    "jitter_bound", "wcet", "wcet_closed_form",
]
