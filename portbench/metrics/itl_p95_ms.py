"""itl_p95_ms (ms): 95th percentile over every decode step of the window
(token in, replay, argmax, synchronize; host clock)."""
from portbench import readers


def read(run):
    return readers.itl_p95_ms(run)
