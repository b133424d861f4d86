"""The shuffle and the commit's device ms a round, read inside the
program: the self device time of the spans ``shuffle`` (the round's draw,
then its argsort and two gathers) and ``commit`` (the argsort, scatter and
gather after the inner steps), over the traced call's rounds."""
from port_bench import phases


def read(inputs):
    return phases.self_ms_round(inputs, ("shuffle", "commit"))
