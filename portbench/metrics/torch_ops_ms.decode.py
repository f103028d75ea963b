"""torch_ops_ms.decode (ms): device time per decode replay in operations
that are not the port's kernels (copies, elementwise, norms, softmax,
cuBLAS)."""
from portbench import readers


def read(run):
    return readers.device_ms_per_replay(run, "decode", None)
