"""The SoftSort apply's device ms a round, read inside the program: the
self device time of the spans ``apply.fwd`` (around the apply in the loss,
every tier) and ``apply.bwd`` (the kernel tier's backward), over the
traced call's rounds."""
from port_bench import phases


def read(inputs):
    return phases.self_ms_round(inputs, ("apply.fwd", "apply.bwd"))
