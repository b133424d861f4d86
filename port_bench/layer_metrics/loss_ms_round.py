"""Eq. 2's device ms a round, forward and backward, read inside the
program: the self device time of the spans ``loss`` (the loss in blocks of
8 rows, the apply's span taken out) and ``backward`` (autograd's backward,
the apply's taken out), over the traced call's rounds."""
from port_bench import phases


def read(inputs):
    return phases.self_ms_round(inputs, ("loss", "backward"))
