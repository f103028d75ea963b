"""host_ms.decode (ms): per decode step, the host's time inside the
step's call, where it launches the decode graph (host clock)."""
from portbench import readers


def read(run):
    return readers.host_ms_decode(run)
