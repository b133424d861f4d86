# Hand-written CUDA kernels for the SoftSort apply (forward + backward),
# dense and banded, each beside its plain PyTorch twin.
#
#   ops.py              — ``softsort_apply`` / ``softsort_apply_banded``:
#                         the autograd.Functions over the four dense and the
#                         four banded kernels; save (perm, m, l, y) residuals
#   softsort_apply.py   — the kernel wrappers (CPU -> plain twin, CUDA ->
#                         kernel, launch counters) and the twins
#   csrc/*.cu           — the CUDA C++ sources, sm_90a
#   build.py            — nvcc build at first use, ctypes loading
#   ref.py              — O(N^2) dense oracle
#
# Importing this package builds nothing: a kernel is compiled at its first
# launch on a CUDA tensor.
from repro_torch.kernels.ops import (  # noqa: F401
    softsort_apply,
    softsort_apply_banded,
)
from repro_torch.kernels.ref import softsort_apply_ref  # noqa: F401
from repro_torch.kernels.softsort_apply import (  # noqa: F401
    KERNELS,
    launch_counts,
    reset_launch_counts,
)
