"""The device's idle share of the traced call: 1 - the union of its
device operations' time over the span's wall time."""


def read(inputs):
    tr = inputs.get("trace")
    if not tr or not tr["window_s"] or not tr["device_ops"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
