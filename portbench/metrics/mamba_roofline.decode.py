"""mamba_roofline.decode (%): the least time of the Mamba layers' work in a
decode replay (products, the recurrence, x, B, C, z and y once; decode: the
state once each way; ``reference/hybrid.py::mamba_costs``) over the
mixer spans' median ms (``program_spans``)."""
from portbench import hybrid_readers


def read(run):
    return hybrid_readers.mamba_roofline(run, "decode")
