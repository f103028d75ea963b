"""mfu.decode (%): model FLOPs of the window's decode steps over their host
time and 989 TFLOP/s."""
from portbench import readers


def read(run):
    return readers.mfu(run, "decode")
