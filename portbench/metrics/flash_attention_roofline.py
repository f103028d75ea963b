"""flash_attention_roofline (%): the bound of a prefill's flash launches
over their traced time per prefill replay."""
from portbench import readers


def read(run):
    return readers.roofline(run, "flash_attention", "prefill")
