"""The whole round's share of the chip's peak, in %: the apply's least
time (``port_bench.counts``) summed over the rounds of the window's
untraced calls, over those calls' wall time.  It bounds what any one
kernel's gain can move."""


def read(inputs):
    wall = inputs.get("window_wall_s")
    if not wall:
        return None
    return 100.0 * inputs["window_least_s"] / wall
