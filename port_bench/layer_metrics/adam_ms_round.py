"""The inner Adam update's device ms a round, read inside the program:
the self device time of the spans ``adam``, over the traced call's
rounds."""
from port_bench import phases


def read(inputs):
    return phases.self_ms_round(inputs, ("adam",))
