"""mfu.prefill (%): model FLOPs of the window's prefills over their time to
first token and 989 TFLOP/s."""
from portbench import readers


def read(run):
    return readers.mfu(run, "prefill")
