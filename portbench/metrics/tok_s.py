"""tok_s (tokens/s): output tokens of the window's batches over its
seconds, from its start to its last batch's end, prefills included."""
from portbench import readers


def read(run):
    return readers.tok_s(run)
