"""The SoftSort apply's share of its roofline, in %: the least time of
the traced call's apply (``port_bench.counts``: forward and backward of
every inner step, from shapes) over the device time of the apply's
kernels in the trace.  The kernels are the port's dense and banded apply
of ``csrc/softsort_apply.cu``, named here; a trace without them (another
apply on the path) gives nothing."""

KERNELS = ("fwd_band_kernel", "colsum_band_kernel",
           "bwd_band_dws_delta_kernel", "bwd_band_dcol_kernel")


def read(inputs):
    tr = inputs.get("trace")
    if not tr:
        return None
    t = sum(dur for name, _, dur, cat in tr["device_ops"]
            if cat == "kernel" and any(k in name for k in KERNELS))
    if t <= 0:
        return None
    return 100.0 * inputs["least_s"] / t
