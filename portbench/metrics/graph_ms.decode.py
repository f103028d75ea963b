"""graph_ms.decode (ms): a decode replay's device time, from its first stamp
to its last; median over the replays of the program's spans pass
(``program_spans``: stamps on the device)."""
from portbench import program_spans


def read(run):
    return program_spans.median_ms(run, "decode", "graph")
