# Hand-written CUDA kernels, each beside its plain PyTorch twin: the
# SoftSort apply (forward + backward, dense and banded, and the v1 split
# forward of the kernel bench), the flash-attention forward, and the
# threefry-2x32 bits and shuffle rounds behind the port's
# jax.random-compatible draws.
#
#   ops.py              — ``softsort_apply`` / ``softsort_apply_banded`` /
#                         ``softsort_apply_v1``: the autograd.Functions over
#                         the SoftSort-apply kernels
#   flash_ops.py        — ``flash_attention`` (autograd.Function over the
#                         one-pass flash kernel and its split-K combine) and
#                         its oracle ``flash_attention_ref``
#   softsort_apply.py,  — the kernel wrappers (CPU -> plain twin, CUDA ->
#   flash_attention.py,   kernel, launch counters) and the twins
#   threefry.py
#   csrc/*.cu           — the CUDA C++ sources, sm_90a
#   build.py, clib.py   — nvcc build at first use; ctypes launch
#   bounds.py           — the least time each kernel's work takes on the card
#   ref.py              — O(N^2) dense SoftSort oracle
#
# Importing this package builds nothing: a kernel is compiled at its first
# launch on a CUDA tensor.
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import softsort_apply as _softsort
from repro_torch.kernels import threefry as _threefry
from repro_torch.kernels.flash_ops import (  # noqa: F401
    flash_attention,
    flash_attention_ref,
)
from repro_torch.kernels.ops import (  # noqa: F401
    softsort_apply,
    softsort_apply_banded,
    softsort_apply_v1,
)
from repro_torch.kernels.ref import softsort_apply_ref  # noqa: F401

KERNELS = _softsort.KERNELS + _flash.KERNELS + _threefry.KERNELS


def reset_launch_counts() -> None:
    """Set the launch count of every kernel of the package to 0."""
    for k in KERNELS:
        k.launches = 0
    _flash.flash_forward.cluster_launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last reset, for every kernel;
    ``flash_forward_cluster`` counts the ``flash_forward`` launches that
    merged their key splits in the cluster epilogue."""
    return {**{k.__name__: k.launches for k in KERNELS},
            "flash_forward_cluster": _flash.flash_forward.cluster_launches}
