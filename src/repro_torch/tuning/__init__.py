"""Serving plans of the port.  This slice carries the default model
plan and ``plan_sig``; the plan cache, candidate enumeration and the
tuners come with the port's tuning slice."""
from repro_torch.tuning.model import (ModelProblem, default_model_plan,
                                      kernel_pins, plan_sig)

__all__ = ["ModelProblem", "default_model_plan", "kernel_pins", "plan_sig"]
