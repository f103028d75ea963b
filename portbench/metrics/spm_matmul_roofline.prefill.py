"""spm_matmul_roofline.prefill (%): the bound of a prefill's products over
spm_matmul's traced time per prefill replay."""
from portbench import readers


def read(run):
    return readers.roofline(run, "spm_matmul", "prefill")
