"""idle_share (%): share of the traced window in which no operation ran on
the device (the union of their intervals)."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
