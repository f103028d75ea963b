"""cache_ms.prefill (ms): device time per prefill replay in the cache's spans
(each layer's cache buffers written, the stack of the layers' caches);
median over the replays of the program's spans pass (``program_spans``:
stamps on the device)."""
from portbench import program_spans


def read(run):
    return program_spans.median_ms(run, "prefill", "cache")
