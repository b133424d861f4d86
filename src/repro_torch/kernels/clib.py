"""Routing and launching for the kernel wrappers.

``route`` picks the path of a wrapper from the device of its operands:
CPU tensors go to the plain twin, CUDA tensors to the kernel.  ``launch``
calls an exported C function of a kernel library (``csrc/<stem>.cu``,
built at first use by ``build``) on the current stream of the operands'
device, raises if the launch failed, and counts it on the wrapper.  The
symbols of each library share a prefix (``ss_``, ``fa_``), and the library
exports ``<prefix>_error_string`` for the CUDA error text.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def route(*tensors) -> str:
    """"cpu" or "cuda": the one device type all operands share."""
    kinds = {t.device.type for t in tensors}
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("operands on different devices: "
                         f"{sorted(map(str, devices))}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


@functools.lru_cache(maxsize=None)
def _symbol(stem: str, name: str, argtypes: tuple, restype):
    """``name`` from the library of ``csrc/<stem>.cu`` (built at first
    use), with its ctypes signature declared."""
    fn = getattr(build.load(stem), name)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def launch(wrapper, stem: str, name: str, argtypes, *args) -> None:
    """Call ``name(*args, stream)``: tensors pass as data pointers, the
    stream is the current one of the tensors' device.  Raise on a CUDA
    error; count the launch on ``wrapper.launches``."""
    fn = _symbol(stem, name, tuple(argtypes) + (P,), ctypes.c_int)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], stream)
    if rc != 0:
        prefix = name.split("_", 1)[0]
        msg = _symbol(stem, f"{prefix}_error_string", (ctypes.c_int,),
                      ctypes.c_char_p)(rc).decode()
        raise RuntimeError(f"{wrapper.__name__}: CUDA launch failed "
                           f"({rc}: {msg})")
    wrapper.launches += 1
