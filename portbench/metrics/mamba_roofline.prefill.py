"""mamba_roofline.prefill (%): the least time of the Mamba layers' work in a
prefill replay (products, the recurrence, x, B, C, z and y once; decode: the
state once each way; ``reference/hybrid.py::mamba_costs``) over the
mixer spans' median ms (``program_spans``)."""
from portbench import hybrid_readers


def read(run):
    return hybrid_readers.mamba_roofline(run, "prefill")
