"""The most memory one inner step's forward graph holds, in MiB: the
program's gauge ``step_graph_bytes`` (the allocator's bytes at the
backward's start less those at the step's start), the largest over the
traced call.  None where the gauge reads nothing (no gauge, or the CPU,
where the allocator counts nothing)."""
from port_bench import phases


def read(inputs):
    rep = phases.report()
    held = rep and rep["gauges"].get("step_graph_bytes")
    if not held:
        return None
    return held / 2 ** 20
