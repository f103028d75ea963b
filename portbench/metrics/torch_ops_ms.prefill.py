"""torch_ops_ms.prefill (ms): device time per prefill replay in operations
that are not the port's kernels."""
from portbench import readers


def read(run):
    return readers.device_ms_per_replay(run, "prefill", None)
