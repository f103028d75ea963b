"""ttft_ms (ms): each batch's time from its prompt copied in to its first
token on the host, averaged over the window's batches."""
from portbench import readers


def read(run):
    return readers.ttft_ms(run)
