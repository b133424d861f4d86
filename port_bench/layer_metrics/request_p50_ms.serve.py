"""The median latency of the requests due in the window, in ms, from
each one's due time to its answer (a request that failed or never came
counts as beyond any latency)."""

import statistics


def read(inputs):
    lat = inputs.get("latencies_ms")
    if not lat:
        return None
    return statistics.median(lat)
