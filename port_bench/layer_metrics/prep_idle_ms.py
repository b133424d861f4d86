"""The device's idle ms in the traced call's preparation: the trace's
idle gaps whose middle lies in the host annotation ``ss.prep`` (the
upload, the normaliser, the repeats and the shuffle source), summed; a
fixed cost of each call."""
from port_bench import phases


def read(inputs):
    return phases.idle_ms(inputs.get("trace"), "prep")
