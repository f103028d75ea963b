"""spm_matmul_roofline.decode (%): the bound of a decode step's products
over spm_matmul's traced time per decode replay."""
from portbench import readers


def read(run):
    return readers.roofline(run, "spm_matmul", "decode")
