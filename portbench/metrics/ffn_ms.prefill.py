"""ffn_ms.prefill (ms): device time per prefill replay in the FFN or channel-
mix spans (with their pre-norms) over all layers; median over the replays
of the program's spans pass (``program_spans``: stamps on the device)."""
from portbench import program_spans


def read(run):
    return program_spans.median_ms(run, "prefill", "ffn")
