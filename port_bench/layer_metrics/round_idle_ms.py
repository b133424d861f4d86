"""The device's idle ms a round: the trace's idle gaps whose middle lies
in a host annotation ``ss.round``, summed, over the traced call's rounds;
a cost paid R times a call."""
from port_bench import phases


def read(inputs):
    ms = phases.idle_ms(inputs.get("trace"), "round")
    if ms is None or not inputs.get("rounds"):
        return None
    return ms / inputs["rounds"]
