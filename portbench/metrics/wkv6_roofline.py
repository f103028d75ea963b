"""wkv6_roofline (%): the bound of a prefill's wkv6 launches over their
traced time per prefill replay."""
from portbench import readers


def read(run):
    return readers.roofline(run, "wkv6", "prefill")
