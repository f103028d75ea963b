"""shared_attention_ms.decode (ms): device time per decode replay in the tied
blocks' attention spans (concat(x, x0), its norm, the attention): the
replay's time outside every group of the program's spans; median over
the replays of the program's spans pass (``program_spans``)."""
from portbench import hybrid_readers


def read(run):
    return hybrid_readers.outside_groups_ms(run, "decode")
