"""The device's idle share of the traced span of the serve window:
``device_idle_frac``'s reader, loaded from its file beside this one."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "port_bench_layer_metrics_device_idle_frac",
    Path(__file__).with_name("device_idle_frac.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
