"""Device kernels per anneal round in the traced call: every kernel in
the trace, the port's and PyTorch's, over the call's rounds."""


def read(inputs):
    tr = inputs.get("trace")
    if not tr or not inputs.get("rounds"):
        return None
    n = sum(1 for *_, cat in tr["device_ops"] if cat == "kernel")
    return n / inputs["rounds"] if n else None
